"""The port's synthetic data pipeline (``pipeline``)."""
