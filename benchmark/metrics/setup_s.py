"""setup_s: process start (the harness's first line) to the first timed
request: imports, the card's start, inputs and weights from the seed, the
cell's shapes warmed."""

from benchmark.lib.readers import setup_s as read  # noqa: F401
