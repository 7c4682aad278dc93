"""commit_ms (kzg.commit-2p20): the window's seconds over the commits completed
in it, ms."""

from benchmark.lib.readers import per_request_ms as read  # noqa: F401
