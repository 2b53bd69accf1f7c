"""Synthetic data streams with checkpointable cursors (counterpart of
repro.data)."""
