"""Share of the service's rounds with nothing on the card, % (spans and the device trace)."""
from mapbench.harness.spanrecords import idle_in_rounds_pct as read  # noqa: F401
