"""Optimizer of the port: AdamW with fp32 or int8 state (``adamw``)."""
