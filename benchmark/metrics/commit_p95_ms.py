"""commit_p95_ms (kzg.commit-2p20): the 95th percentile of every commit's
latency in the window, from the call to the commitment on the host, ms."""

from benchmark.lib.readers import p95_ms as read  # noqa: F401
