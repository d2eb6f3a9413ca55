"""The five mapping kernels' summed least time over their summed device time, %."""
from mapbench.harness import records


def read(rec):
    return records.roofline_pct(rec, "direct")
