"""Kernel A's share of its roofline on doubled frames, in per cent (see
`_doubled.detect_roofline`)."""

from portbench.layer_metrics._doubled import detect_roofline as read  # noqa: F401
