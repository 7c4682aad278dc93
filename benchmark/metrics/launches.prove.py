"""launches.prove: the port's kernel launches (ops/_build.py LAUNCHES) a proof
in the window."""

from benchmark.lib.readers import launches as read  # noqa: F401
