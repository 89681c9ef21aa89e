"""Device ops: masking, BEV projector, the CUDA splat kernel, dropout."""
