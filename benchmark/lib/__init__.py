"""The benchmark's own code: the run, the traffic generator, the trace
reduction, the seed streams and the yardstick.  Imports nothing of the
program at module level."""
