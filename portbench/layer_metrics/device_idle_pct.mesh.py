"""Rank 0's device idle share in the mesh cell, in per cent (see
`_common.device_idle_pct`)."""

from portbench.layer_metrics._common import device_idle_pct as read  # noqa: F401
