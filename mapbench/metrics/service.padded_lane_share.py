"""Padded lanes over all lanes of the service's dispatches, %."""
from mapbench.harness.records import padded_lane_share as read  # noqa: F401
