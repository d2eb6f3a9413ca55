"""The card's seconds in a map's root level (the ``planner.level`` span's device time)."""
from mapbench.harness.spanrecords import root_level_device_s as read  # noqa: F401
