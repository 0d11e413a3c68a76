"""The multi-process runtime (port of cuda_surf_tpu/parallel/multihost.py).

One process per device: `initialize_from_env` forms the
`torch.distributed` process group from the launch contract below, each
rank on one device; `global_mesh` is the mesh over every rank, and
`global_batch` places a rank's own rows of a frame batch on its device.

Environment contract (set by the launcher, one process per device):

  SURF_COORDINATOR   host:port of rank 0 (required to enable)
  SURF_NUM_PROCESSES total process count
  SURF_PROCESS_ID    this process's rank

The backend is chosen explicitly and printed: `nccl` for CUDA tensors on
distinct cards, `gloo` for CPU tensors and for ranks that share one card
(NCCL refuses two ranks on one GPU).  Nothing switches backend or device
behind the caller's back: with the SURF_* variables set, a group that
cannot form raises.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from .mesh import (FRAME_AXIS, Mesh, all_gather_rows, default_device,
                   make_mesh, set_rank_device)


def multiprocess_env() -> bool:
    """True when a multi-process launch is configured in the env."""
    return "SURF_COORDINATOR" in os.environ


def initialize_from_env(timeout_s: int = 60, backend: str | None = None,
                        device=None) -> bool:
    """Form the process group from the environment.

    Returns True if running multi-process (after initialisation), False
    for the ordinary single-process case.  Idempotent.  `device` is this
    rank's device (default `cuda:{rank % device_count}`, raising without a
    card); `backend` defaults to "nccl" for a CUDA device and "gloo" for
    the CPU."""
    if dist.is_initialized():
        return True
    if not multiprocess_env():
        return False
    coord = os.environ["SURF_COORDINATOR"]
    missing = [k for k in ("SURF_NUM_PROCESSES", "SURF_PROCESS_ID")
               if k not in os.environ]
    if missing:
        raise RuntimeError(
            "SURF_COORDINATOR is set but the launch contract is "
            f"incomplete: missing {', '.join(missing)} (set all three "
            "SURF_* variables, or none to run as one process)")
    nproc = int(os.environ["SURF_NUM_PROCESSES"])
    pid = int(os.environ["SURF_PROCESS_ID"])
    device = default_device(pid) if device is None else torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # torch's flight recorder captures the Python stack of every
    # collective; inside the distributed CG that made an NCCL all-reduce
    # cost 99-309 us of host against 57-68 us without (probe_collectives.py
    # on an H100, PERF.md), so it is off unless the environment sets it
    os.environ.setdefault("TORCH_NCCL_TRACE_BUFFER_SIZE", "0")
    print(f"initialize_from_env: rank {pid} of {nproc}, backend {backend}, "
          f"device {device}, flight recorder buffer "
          f"{os.environ['TORCH_NCCL_TRACE_BUFFER_SIZE']}", file=sys.stderr,
          flush=True)
    dist.init_process_group(
        backend, init_method=f"tcp://{coord}", world_size=nproc, rank=pid,
        timeout=datetime.timedelta(seconds=timeout_s))
    set_rank_device(device)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(axis_name: str = FRAME_AXIS) -> Mesh:
    """1-D mesh over every rank of the group, each on its device."""
    return make_mesh(axis_name=axis_name)


def global_batch(host_local: np.ndarray, mesh: Mesh,
                 axis_name: str = FRAME_AXIS) -> torch.Tensor:
    """This rank's shard of a global batch that is the leading-axis
    concatenation, in rank order, of every rank's `host_local`: the rank
    feeds only its own rows, which go to its device (the counterpart of
    `jax.make_array_from_process_local_data`)."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"global_batch: mesh axis {mesh.axis_name!r}, "
                         f"asked for {axis_name!r}")
    return torch.as_tensor(np.asarray(host_local)).to(mesh.device)


def all_processes_value(x, mesh: Mesh | None = None) -> np.ndarray:
    """Every rank's value of `x` (the same shape on each), gathered to every
    rank: (process_count(), *x.shape) on the host, row r rank r's.  For
    logging and for checking that a replicated value agrees across
    ranks."""
    mesh = make_mesh() if mesh is None else mesh
    t = torch.as_tensor(x).to(mesh.device)
    return all_gather_rows(t[None], mesh).cpu().numpy()
