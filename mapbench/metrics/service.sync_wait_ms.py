"""Ms per job the scheduler thread waits on the planner's fetches (program spans)."""
from mapbench.harness.spanrecords import sync_wait_ms as read  # noqa: F401
