"""The device mesh (port of cuda_surf_tpu/parallel/mesh.py).

JAX puts a mesh and its collectives in one program over many local devices
(`shard_map` + `lax.psum`).  PyTorch's idiom is one process per device with
collectives on a `torch.distributed` process group, and the port follows
it: a rank owns one `torch.device`, a mesh is the group's ranks along one
named axis (`FRAME_AXIS`), and a `psum` is an `all_reduce` on the group.

A process with no group initialised has a mesh of one device and no group;
its collectives are the identity, so every distributed function also runs
in a plain single process.  A mesh with a group calls the backend even at
a world of one (NCCL's all-reduce of one rank returns its input).

Frame batches are split over the ranks by rows (`shard_rows`, the
counterpart of `frame_sharding`); cameras and nodes are held whole by
every rank (`replicated`).  A rank's results come back whole to every rank
by `all_gather_rows`, and several small fields in one all-gather by
`all_gather_fields`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .._build import require_device
from ..utils.timing import span

FRAME_AXIS = "frames"

# this rank's device, set by multihost.initialize_from_env with the group
_rank_device: torch.device | None = None

# collectives that reached the process group's backend: all-reduces,
# all-gathers, and the bytes this rank received by all-gather; a reader sets
# each count to 0 before the work it counts
collective_counts = {"all_reduce": 0, "all_gather": 0, "all_gather_bytes": 0}

# the one-buffer all-gather (its older name in torch releases before it)
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a process group along one named axis, seen from one
    rank: `size` ranks, this one `rank`, on `device`.  `group` is None for
    the mesh of one device of a process without a group."""
    axis_name: str
    size: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)


def default_device(rank: int = 0) -> torch.device:
    """This rank's card, `cuda:{rank % device_count}`; raises without one
    (a rank runs on the CPU only where the caller asks for "cpu")."""
    require_device("cuda", "default_device")
    return torch.device("cuda", rank % torch.cuda.device_count())


def set_rank_device(device: torch.device) -> None:
    """Record the device this rank's process group was formed with."""
    global _rank_device
    _rank_device = torch.device(device)


def rank_device() -> torch.device:
    """The device recorded with the initialised group; else this rank's
    card (`default_device`)."""
    if dist.is_available() and dist.is_initialized():
        if _rank_device is not None:
            return _rank_device
        return default_device(dist.get_rank())
    return default_device(0)


def make_mesh(n_devices: int | None = None, devices=None,
              axis_name: str = FRAME_AXIS) -> Mesh:
    """The mesh over every rank of the initialised group (one device, no
    group, without one).  `n_devices` other than that size raises.
    `devices` is this rank's device; without it the rank takes
    `rank_device()`."""
    if dist.is_available() and dist.is_initialized():
        size, rank, group = dist.get_world_size(), dist.get_rank(), \
            dist.group.WORLD
    else:
        size, rank, group = 1, 0, None
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): the process group holds "
                         f"{size} rank(s), one device each")
    device = rank_device() if devices is None else torch.device(devices)
    require_device(device.type, "make_mesh")
    return Mesh(axis_name, size, rank, device, group)


def shard_rows(x, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of the leading axis of `x` (a tensor or array that
    every rank holds whole), on the rank's device.  Raises when the
    leading axis does not divide by the mesh size, as `jax.device_put` on a
    frame sharding does."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"leading axis {n} not divisible by mesh size "
                         f"{mesh.size}")
    k = n // mesh.size
    return x[mesh.rank * k:(mesh.rank + 1) * k].to(mesh.device)


# the JAX package's name of the leading-axis split
frame_sharding = shard_rows


def replicated(x, mesh: Mesh) -> torch.Tensor:
    """`x`, which every rank holds whole, on the rank's device."""
    return torch.as_tensor(x).to(mesh.device)


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `x` over the mesh's ranks, in one all-reduce: `x` itself
    without a group.  A contiguous `x` is reduced in place, so callers
    pass a tensor of their own (a fresh sum).  Every rank gets the same
    bits."""
    if mesh.group is None:
        return x
    out = x.contiguous()
    dist.all_reduce(out, group=mesh.group)
    collective_counts["all_reduce"] += 1
    return out


def _all_gather(src: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' contiguous `src` along a new leading block, counted."""
    out = src.new_empty((mesh.size * src.shape[0], *src.shape[1:]))
    _gather_into(out, src, group=mesh.group)
    collective_counts["all_gather"] += 1
    collective_counts["all_gather_bytes"] += \
        (mesh.size - 1) * src.numel() * src.element_size()
    return out


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's `x` (the same shape on each) concatenated along the
    leading axis in rank order, in one all-gather: the host view of a
    frame-sharded result.  bool travels as uint8."""
    if mesh.group is None:
        return x
    with span("mesh.all_gather"):
        if x.dtype == torch.bool:
            return _all_gather(x.to(torch.uint8), mesh).to(torch.bool)
        return _all_gather(x.contiguous(), mesh)


def all_gather_fields(fields, mesh: Mesh) -> list:
    """`all_gather_rows` of each tensor of `fields` (float32, int32 or
    bool, all with the same leading axis), in ONE all-gather: each rank
    packs its rows of every field into one buffer of 32-bit words (float32
    bitcast, bool as a word), and the gathered words are unpacked bit for
    bit."""
    if mesh.group is None:
        return list(fields)
    with span("mesh.all_gather"):
        k = fields[0].shape[0]
        words = [(f.to(torch.int32) if f.dtype == torch.bool
                  else f.contiguous().view(torch.int32)).reshape(k, -1)
                 for f in fields]
        got = _all_gather(torch.cat(words, 1), mesh)
        out = []
        for f, w in zip(fields, torch.split(got, [w.shape[1] for w in words],
                                            1)):
            w = w.contiguous().reshape(-1, *f.shape[1:])
            out.append(w != 0 if f.dtype == torch.bool else w.view(f.dtype))
        return out
