"""Device ops per job, from the window's CUDA trace."""
from mapbench.harness import records


def read(rec):
    return records.device_ops(rec, "service")
