"""A job's mean wait from its submit to its admission (``service.queue`` spans)."""
from mapbench.harness.spanrecords import queue_wait_ms as read  # noqa: F401
