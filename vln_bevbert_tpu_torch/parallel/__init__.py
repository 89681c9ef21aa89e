"""Pretraining step: optimizer and train step (CUDA card or CPU); data
parallelism over ``torch.distributed`` (``distributed``, ``mesh``)."""
