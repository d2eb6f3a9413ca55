"""SharedMap core in PyTorch: the port of ``repro.core``."""
