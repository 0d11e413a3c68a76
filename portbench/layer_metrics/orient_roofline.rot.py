"""Kernel D's share of its roofline in a rotated cell, in per cent (see
`_rotated.orient_roofline`)."""

from portbench.layer_metrics._rotated import orient_roofline as read  # noqa: F401
