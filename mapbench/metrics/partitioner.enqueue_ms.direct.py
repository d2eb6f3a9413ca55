"""Ms per map the host spends issuing the v-cycle (``partitioner.batch`` spans)."""
from mapbench.harness.spanrecords import partitioner_enqueue_ms as read  # noqa: F401
