"""Host ms per job in the service's rounds, less the planner's fetches (program spans)."""
from mapbench.harness.spanrecords import round_host_ms as read  # noqa: F401
