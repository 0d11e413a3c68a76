"""Device operations a frame: torch.profiler's device events in the
traced block over the frames it completed.  The launch-bound glue between
the kernels is most of them."""

from portbench.layer_metrics._common import device_ops_per_frame as read  # noqa: F401
