"""The rotated kernel B's share of its roofline in a rotated cell, in per
cent (see `_rotated.describe_roofline`)."""

from portbench.layer_metrics._rotated import describe_roofline as read  # noqa: F401
