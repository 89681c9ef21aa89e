"""Pretraining step: optimizer and train step (CUDA card or CPU)."""
