"""Share of the traced window in which the card ran nothing, %."""
from mapbench.harness import records


def read(rec):
    return records.idle_pct(rec, "service")
