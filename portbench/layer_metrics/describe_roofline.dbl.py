"""Kernel B's share of its roofline on doubled frames, in per cent (see
`_doubled.describe_roofline`)."""

from portbench.layer_metrics._doubled import describe_roofline as read  # noqa: F401
