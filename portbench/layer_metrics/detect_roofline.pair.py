"""Kernel A's share of its roofline in a pair cell, in per cent (see
`_common.detect_roofline`)."""

from portbench.layer_metrics._common import detect_roofline as read  # noqa: F401
