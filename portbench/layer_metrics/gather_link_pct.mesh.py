"""The mesh's all-gathers' share of their roofline, in per cent (see
`_mesh.gather_link_pct`)."""

from portbench.layer_metrics._mesh import gather_link_pct as read  # noqa: F401
