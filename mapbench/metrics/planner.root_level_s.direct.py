"""Host seconds of the root level per map (``stats['levels'][0]``)."""
from mapbench.harness.records import root_level_s as read  # noqa: F401
