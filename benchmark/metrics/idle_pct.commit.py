"""idle_pct.commit: the share of the traced window with nothing running on the
card, percent."""

from benchmark.lib.readers import idle_pct as read  # noqa: F401
