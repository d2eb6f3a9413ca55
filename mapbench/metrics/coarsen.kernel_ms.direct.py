"""Device ms per map in ``hem_propose`` and ``contract_edges``."""
from mapbench.harness.records import coarsen_ms as read  # noqa: F401
