"""The pretraining loop."""
