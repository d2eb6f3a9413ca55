"""Mean J over the run's fixed set of first requests."""
from mapbench.harness.records import cost_J as read  # noqa: F401
