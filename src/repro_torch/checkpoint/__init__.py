"""Checkpoints of the port: atomic, keep-k, async, verified (``checkpointer``)."""
