"""Host data pipeline: nav graphs, trajectories, static-shape batches,
the pretraining loader, feature stores, annotations."""
