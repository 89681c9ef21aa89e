"""PyTorch model library mirroring vln_bevbert_tpu/models."""
