"""NCCL all-gather kernel time a request of the mesh, ms, on rank 0 (its
wait for the slowest rank included; see `_mesh.gather_ms`)."""

from portbench.layer_metrics._mesh import gather_ms as read  # noqa: F401
