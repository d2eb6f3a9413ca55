"""Coalesced lanes per dispatch of the service over the window."""
from mapbench.harness.records import lanes_per_dispatch as read  # noqa: F401
