"""Device ops: masking, BEV projector, the CUDA splat and dropout kernels."""
