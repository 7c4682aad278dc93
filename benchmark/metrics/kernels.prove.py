"""kernels.prove: every kernel the card ran in the traced window, the program's
and PyTorch's alike (copies and fills not counted), a prove."""

from benchmark.lib.readers import kernels as read  # noqa: F401
