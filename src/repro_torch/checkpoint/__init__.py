"""Fault-tolerant checkpointing (counterpart of repro.checkpoint)."""
