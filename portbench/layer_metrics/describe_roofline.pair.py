"""Kernel B's share of its roofline in a pair cell, in per cent (see
`_common.describe_roofline`)."""

from portbench.layer_metrics._common import describe_roofline as read  # noqa: F401
