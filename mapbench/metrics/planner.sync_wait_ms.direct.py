"""Ms per map the host waits on the planner's device-to-host fetches (program spans)."""
from mapbench.harness.spanrecords import planner_sync_wait_ms as read  # noqa: F401
