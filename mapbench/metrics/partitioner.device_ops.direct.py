"""Device ops per map, from the window's CUDA trace."""
from mapbench.harness import records


def read(rec):
    return records.device_ops(rec, "direct")
