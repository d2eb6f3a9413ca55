"""The planner's own host ms per map, its fetches left out (program spans)."""
from mapbench.harness.spanrecords import planner_host_ms as read  # noqa: F401
