"""msm_device_ms: the card's time of every kernel, copy and fill in the traced
window over the commits in it (each request is one commit), ms."""

from benchmark.lib.readers import device_ms as read  # noqa: F401
