"""Rank 0's device operations over the frames the traced block completed
on all ranks: a rank does a ranks-th of a request's frames, so this is a
ranks-th of what one card launches a frame of its own."""

from portbench.layer_metrics._common import device_ops_per_frame as read  # noqa: F401
