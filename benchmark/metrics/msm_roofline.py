"""msm_roofline: the least time of one commit's MSM (benchmark/lib/work.py)
over its device time, percent."""

from benchmark.lib.readers import msm_roofline as read  # noqa: F401
