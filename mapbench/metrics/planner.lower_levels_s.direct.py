"""Host seconds of the levels below the root per map."""
from mapbench.harness.records import lower_levels_s as read  # noqa: F401
