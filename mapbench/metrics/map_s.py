"""The whole window over the maps completed in it (direct cells)."""
from mapbench.harness.records import map_s as read  # noqa: F401
