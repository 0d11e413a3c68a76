"""Device operations a frame in a doubled cell: torch.profiler's device
events in the traced block over the frames it completed."""

from portbench.layer_metrics._common import device_ops_per_frame as read  # noqa: F401
