"""The device's idle share in a doubled cell: the traced block less the
union of its device events' intervals, over the block, in per cent."""

from portbench.layer_metrics._common import device_idle_pct as read  # noqa: F401
