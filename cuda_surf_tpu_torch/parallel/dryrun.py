"""The multi-device dry run (port of `dryrun_multichip` in the repository's
__graft_entry__.py) and its launcher.

`dryrun_multichip(n_devices)` runs one distributed step of each layer at
tiny shapes on whatever process group is initialised (or a world of one):
the data-parallel frontend (`BatchSurf` with a mesh), the distributed
Schur-complement BA (its observations with 1e-3 noise, which the JAX dry
run lacks, so that its cost falls to a floor above zero) and the
edge-split pose graph.  It prints one summary
line.  The launcher starts N local ranks with the SURF_* variables of
`multihost` set, one process each, and waits for them under a time limit:

    python -m cuda_surf_tpu_torch.parallel.dryrun --nproc 2 --backend gloo \\
        --device cpu
    python -m cuda_surf_tpu_torch.parallel.dryrun --nproc 1 --backend nccl \\
        --device cuda

A rank that fails, or a launch that outlives `--timeout`, kills every rank
and exits non-zero.  `SURF_DRYRUN_FULLRES=1` (the launcher passes the
environment on to every rank) adds one frontend step at the production
shape (1280x960, 4 octaves, 4096 points).
Before its summary line each rank prints its numbers as one JSON object,
after `dryrun detail: `.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..ba import BAProblem, BAState, cost, make_distributed_lm, shard_problem
from ..config import SurfConfig
from ..slam.posegraph import PoseGraph, optimize_distributed
from .batch import BatchSurf
from .mesh import default_device, make_mesh, psum
from .multihost import global_mesh, initialize_from_env, multiprocess_env


def dryrun_multichip(n_devices: int, full_res: bool | None = None,
                     device=None) -> dict:
    """One step of the data-parallel frontend, the distributed BA and the
    distributed pose graph on an n-device mesh with tiny shapes.

    In a launched rank (SURF_* set) the process group is formed first and
    the mesh spans every rank; else the mesh is this process's one device
    (`device`, default the card).  -> the summary's numbers, which every
    rank holds."""
    if full_res is None:
        full_res = os.environ.get("SURF_DRYRUN_FULLRES") == "1"
    if initialize_from_env(device=device):
        mesh = global_mesh()
        n_devices = mesh.size
    else:
        mesh = make_mesh(n_devices, devices=device)
    dev_type = mesh.device.type
    rng = np.random.default_rng(0)

    # --- data-parallel frontend: frame batch split over the ranks ---------
    cfg = SurfConfig(noctaves=2, max_pts=128, candidates_per_octave=128)
    batch = rng.integers(0, 256, (n_devices, 96, 128), dtype=np.uint8)
    kps, descs = BatchSurf(cfg, dev_type, mesh).detect_and_compute(batch)
    if descs.shape != (n_devices, cfg.max_pts, cfg.nfeatures):
        raise AssertionError(f"dryrun: descriptors {tuple(descs.shape)}")
    counts = kps.count.tolist()

    if full_res:
        cfg_full = SurfConfig(noctaves=4, thresh=4.0, max_pts=4096,
                              candidates_per_octave=4096)
        big = rng.integers(0, 256, (n_devices, 960, 1280), dtype=np.uint8)
        fk, fd = BatchSurf(cfg_full, dev_type, mesh).detect_and_compute(big)
        if fd.shape != (n_devices, cfg_full.max_pts, cfg_full.nfeatures):
            raise AssertionError(f"dryrun: full-res descriptors "
                                 f"{tuple(fd.shape)}")
        print(f"dryrun full-res frontend counts={fk.count.tolist()}",
              flush=True)

    # --- distributed BA: points split, camera system all-reduced ----------
    n_cam, n_pts = 4, 8 * n_devices
    X = rng.uniform([-2, -2, 6], [2, 2, 12], (n_pts, 3))
    Rs = np.tile(np.eye(3), (n_cam, 1, 1))
    ts = np.stack([np.array([0.3 * c, 0.0, 0.0]) for c in range(n_cam)])
    cam_idx = np.tile(np.arange(n_cam), (n_pts, 1))
    xc = np.einsum("cij,pj->pci", Rs, X) + ts[None]
    # observation noise, so that the cost falls to a floor above zero
    uv = (xc[..., :2] / xc[..., 2:]
          + rng.normal(0, 1e-3, (n_pts, n_cam, 2))).astype(np.float32)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    prob = BAProblem(torch.as_tensor(cam_idx, dtype=torch.int32),
                     torch.as_tensor(uv), torch.ones((n_pts, n_cam),
                                                     dtype=torch.bool))
    state = BAState(f32(Rs), f32(ts + 0.01), f32(X + 0.01))
    prob, state = shard_problem(prob, state, mesh)
    ba_cost0 = float(psum(cost(state, prob), mesh))
    _, ba_cost = make_distributed_lm(mesh, n_cameras=n_cam, n_iters=2)(
        state, prob)
    ba_cost = float(ba_cost)
    if not np.isfinite(ba_cost):
        raise AssertionError(f"dryrun: BA cost {ba_cost}")

    # --- distributed pose graph: edges split, one all-reduce a matvec -----
    n_nodes = 12
    th = np.linspace(0, 2 * np.pi, n_nodes, endpoint=False)
    Rsg = np.stack([np.array([[np.cos(a), -np.sin(a), 0],
                              [np.sin(a), np.cos(a), 0],
                              [0, 0, 1.0]]) for a in th])
    tsg = np.stack([np.array([np.cos(a), np.sin(a), 0.0]) for a in th])
    ei = np.arange(n_nodes - 1)
    ej = ei + 1
    rel_R = np.einsum("eji,ejk->eik", Rsg[ei], Rsg[ej])
    rel_t = np.einsum("eji,ej->ei", Rsg[ei], tsg[ej] - tsg[ei])
    graph = PoseGraph(f32(Rsg), f32(tsg + rng.normal(0, 0.02, tsg.shape)),
                      torch.as_tensor(ei), torch.as_tensor(ej), f32(rel_R),
                      f32(rel_t), torch.ones(len(ei)))
    _, gcosts = optimize_distributed(graph, mesh, n_iters=2)
    pg_cost = float(gcosts[-1])
    if not np.isfinite(pg_cost):
        raise AssertionError(f"dryrun: posegraph cost {pg_cost}")

    summary = dict(n_devices=n_devices, counts=counts, ba_cost0=ba_cost0,
                   ba_cost=ba_cost, posegraph_cost=pg_cost,
                   backend=mesh.backend, device=str(mesh.device))
    print(f"dryrun detail: {json.dumps(summary)}", flush=True)
    print(f"dryrun_multichip({n_devices}): frontend counts={counts}, "
          f"BA cost={ba_cost:.6f}, posegraph cost={pg_cost:.6f}",
          flush=True)
    return summary


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(nproc: int, argv: list[str], timeout: float) -> list[str]:
    """Start `nproc` local ranks of `python <argv>` with the SURF_* launch
    contract set, and wait for all of them; -> each rank's output (stdout
    and stderr).  When a rank fails, or `timeout` seconds pass, every rank
    still running is killed (a peer of a dead rank blocks in its next
    collective) and this raises with the outputs."""
    port = free_port()
    deadline = time.monotonic() + timeout
    with contextlib.ExitStack() as stack:
        logs = [stack.enter_context(tempfile.TemporaryFile("w+"))
                for _ in range(nproc)]
        procs = []
        try:
            for rank, log in enumerate(logs):
                env = dict(os.environ,
                           SURF_COORDINATOR=f"127.0.0.1:{port}",
                           SURF_NUM_PROCESSES=str(nproc),
                           SURF_PROCESS_ID=str(rank))
                procs.append(subprocess.Popen(
                    [sys.executable, *argv], env=env, stdout=log,
                    stderr=subprocess.STDOUT, text=True))
            while time.monotonic() < deadline:
                codes = [p.poll() for p in procs]
                if None not in codes or any(codes):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            outs = []
            for log in logs:
                log.seek(0)
                outs.append(log.read())
    bad = [f"rank {r} exited {p.returncode}:\n{out}"
           for r, (p, out) in enumerate(zip(procs, outs)) if p.returncode]
    if bad:
        raise RuntimeError(f"launch of {nproc} ranks failed or passed its "
                           f"{timeout} s limit (killed ranks exit -9):\n"
                           + "\n".join(bad))
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if multiprocess_env():                         # a launched rank
        rank = int(os.environ.get("SURF_PROCESS_ID", "0"))
        device = torch.device("cpu") if args.device == "cpu" else \
            default_device(rank)
        initialize_from_env(backend=args.backend, device=device)
        dryrun_multichip(args.nproc, device=device)
        torch.distributed.destroy_process_group()
        return 0
    rank_argv = ["-m", "cuda_surf_tpu_torch.parallel.dryrun",
                 "--nproc", str(args.nproc), "--device", args.device,
                 "--timeout", str(args.timeout)]
    if args.backend:
        rank_argv += ["--backend", args.backend]
    for rank, out in enumerate(launch(args.nproc, rank_argv, args.timeout)):
        for line in out.splitlines():
            print(f"[rank {rank}] {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
