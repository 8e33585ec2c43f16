"""Training data of the port: the synthetic token pipeline (``pipeline``)."""
