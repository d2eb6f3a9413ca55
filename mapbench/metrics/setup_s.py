"""From process start to the first timed call: import, library load, inputs, warm-up."""
from mapbench.harness.records import setup_s as read  # noqa: F401
