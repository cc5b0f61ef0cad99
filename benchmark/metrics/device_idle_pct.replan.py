"""``device_idle_pct``: share (%) of the traced window, host clock from the
first traced call to its last answer, in which no kernel, copy or set ran
on the card."""

from benchmark.harness import idle_pct as read  # noqa: F401
