"""Share of the serving window in which no operation ran on the card (%)."""

from portbench.readers import idle_share as read  # noqa: F401
