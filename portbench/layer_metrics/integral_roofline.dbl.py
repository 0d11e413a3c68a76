"""Kernel G's doubled passes' share of their roofline in a doubled cell,
in per cent (see `_doubled.integral_roofline`)."""

from portbench.layer_metrics._doubled import integral_roofline as read  # noqa: F401
