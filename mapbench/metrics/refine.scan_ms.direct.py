"""Device ms per map in kernels named like ``*scan*`` (``graph.row_cumsum``,
the refinement's scans)."""
from mapbench.harness.records import scan_ms as read  # noqa: F401
