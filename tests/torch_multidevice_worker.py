"""One rank of the port's multi-device tests (imports torch, never jax).

Started by `torch_parity.run_ranks` through the port's launcher
(`cuda_surf_tpu_torch.parallel.dryrun.launch`), which sets SURF_COORDINATOR /
SURF_NUM_PROCESSES / SURF_PROCESS_ID and kills every rank on a failure or a
timeout:

    python tests/torch_multidevice_worker.py TASK IN.npz OUT_DIR \\
        [--device cpu|cuda|cuda:N] [--backend gloo|nccl]

The rank forms the process group with `initialize_from_env`, runs TASK on
the inputs of IN.npz (the same file for every rank) and writes its results
to OUT_DIR/rank<r>.npz.  Values that the mesh replicates are written as
each rank holds them, so the test can hold them bit-equal across ranks;
sharded values are all-gathered first.
"""

import argparse
import json
import os
import re
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np
import torch


def task_ba(mesh, inp):
    """make_distributed_lm on the rank's points -> cameras, gathered points
    and the final cost; plus the cost before the first iteration."""
    from cuda_surf_tpu_torch.ba import core, make_distributed_lm, shard_problem
    from cuda_surf_tpu_torch.parallel.mesh import all_gather_rows, psum
    prob = core.BAProblem(torch.as_tensor(inp["cam_idx"]),
                          torch.as_tensor(inp["uv"]),
                          torch.as_tensor(inp["mask"]))
    state = core.BAState(*(torch.as_tensor(inp[k]) for k in ("R", "t", "X")))
    prob, state = shard_problem(prob, state, mesh)
    cost0 = psum(core.cost(state, prob), mesh)
    n_cam = state.R.shape[0]
    run = make_distributed_lm(mesh, n_cam, n_iters=int(inp["n_iters"]))
    out, c = run(state, prob)
    return dict(R=out.R, t=out.t, points=all_gather_rows(out.points, mesh),
                cost=c, cost0=cost0)


def task_posegraph(mesh, inp):
    """optimize_distributed on each case of the input (`<case>_<field>`),
    -> `<case>_R`, `<case>_t`, `<case>_costs`, `<case>_rounds`."""
    from cuda_surf_tpu_torch.slam import posegraph
    res = {}
    for case in json.loads(str(inp["cases"])):
        meta = json.loads(str(inp[f"{case}_meta"]))
        src = SimpleNamespace(**{k: inp[f"{case}_{k}"]
                                 for k in posegraph.PoseGraph._fields})
        g = posegraph.graph_from_numpy(src, mesh.device.type)
        mask = inp.get(f"{case}_robust_mask")
        stats = {}
        out, costs = posegraph.optimize_distributed(
            g, mesh, n_iters=meta["n_iters"],
            robust_delta=meta.get("robust_delta"),
            robust_mask=None if mask is None else torch.as_tensor(mask),
            stats=stats)
        res.update({f"{case}_R": out.R, f"{case}_t": out.t,
                    f"{case}_costs": costs,
                    f"{case}_rounds": np.asarray(stats["cg_rounds"])})
    return res


def task_batch(mesh, inp):
    """BatchSurf(mesh=) on the frames and its match of frame i -> i + 1,
    with each kernel's launches on the rank (A, the stacked B, C; 0 on the
    CPU, where the wrappers run their twins)."""
    from cuda_surf_tpu_torch import BatchSurf, SurfConfig, _build
    from cuda_surf_tpu_torch.types import Keypoints
    kernels = dict(A="surf_pyramid", B="surf_describe_stacked", C="surf_best2")
    before = _build.launch_counts.copy()
    cfg = SurfConfig(**json.loads(str(inp["cfg"])))
    bs = BatchSurf(cfg, mesh.device.type, mesh=mesh)
    kps, descs = bs.detect_and_compute(inp["frames"])
    sub = lambda sl: Keypoints(*[f[sl] for f in kps])
    m = bs.match(sub(slice(0, -1)), descs[:-1], sub(slice(1, None)),
                 descs[1:])
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    res = {f"kp_{k}": v for k, v in kps._asdict().items()}
    res.update(descs=descs, match_score=m.score, match_index=m.index,
               **{f"launches_{k}": np.int64(_build.launch_counts[entry]
                                            - before[entry])
                  for k, entry in kernels.items()})
    return res


def _gather_spans(events) -> list:
    """The innermost stage span open at each host event of the backend's
    all-gather: by the event's chain of parents, else (a backend's work
    recorded on its own thread) by its start inside a span's interval."""
    from cuda_surf_tpu_torch.utils import SPANS
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.name in SPANS]
    out = []
    for e in events:
        if not re.search(r"all_?gather", e.name, re.I) or e.name in SPANS:
            continue
        p = e.cpu_parent
        while p is not None and p.name not in SPANS:
            p = p.cpu_parent
        if p is None:
            t = e.time_range.start
            inside = [s for s in spans if s[0] <= t <= s[1]]
            p = min(inside, key=lambda s: s[1] - s[0])[2] if inside else None
        else:
            p = p.name
        out.append(str(p))
    return out


def task_sequence(mesh, inp):
    """A sequence batch as a mesh serves it: BatchSurf(mesh=)
    .detect_and_compute of the frames, then its match_sequence, with the
    all-gathers and bytes they made (`collective_counts`); then the same
    calls under torch.profiler, -> the span each host event of the
    backend's all-gather ran in."""
    from torch.profiler import ProfilerActivity, profile

    from cuda_surf_tpu_torch import BatchSurf, SurfConfig
    from cuda_surf_tpu_torch.parallel.mesh import collective_counts
    bs = BatchSurf(SurfConfig(**json.loads(str(inp["cfg"]))),
                   mesh.device.type, mesh=mesh)

    def request():
        kps, descs = bs.detect_and_compute(inp["frames"])
        return kps, descs, bs.match_sequence(kps, descs)

    collective_counts.update(all_gather=0, all_gather_bytes=0)
    kps, descs, m = request()
    counts = dict(collective_counts)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        request()
    res = {f"kp_{k}": v for k, v in kps._asdict().items()}
    res.update({f"match_{k}": v for k, v in m._asdict().items()})
    res.update(descs=descs, all_gathers=np.int64(counts["all_gather"]),
               all_gather_bytes=np.int64(counts["all_gather_bytes"]),
               gather_spans=np.asarray(_gather_spans(prof.events())))
    return res


def task_elastic(mesh, inp):
    """run_elastic over each scenario's checkpoint directory of this rank
    (IN's `<scenario>_dir_<rank>`; host-local state where IN's
    `<scenario>_all_processes` is set) from the state x = 1, recording the
    steps it ran."""
    from cuda_surf_tpu_torch.parallel import CheckpointDir, run_elastic
    res = {}
    for sc in json.loads(str(inp["scenarios"])):
        ran = []

        def step(k, state):
            ran.append(k)
            return {"x": (np.asarray(state["x"]) * 3 + k) % (2 ** 31)}

        ck = CheckpointDir(str(inp[f"{sc}_dir_{mesh.rank}"]))
        out = run_elastic(step, {"x": np.int64(1)},
                          n_steps=int(inp["n_steps"]), ckpt=ck, ckpt_every=10,
                          all_processes=bool(inp.get(f"{sc}_all_processes",
                                                     False)))
        res.update({f"{sc}_x": np.asarray(out["x"]),
                    f"{sc}_ran": np.asarray(ran, np.int64)})
    return res


def task_multihost(mesh, inp):
    """Each rank's 4 rows of 16 values rank + 1 through global_batch, and
    one all-reduce of their sum; the rank bookkeeping and
    all_processes_value."""
    from cuda_surf_tpu_torch.parallel import (all_processes_value,
                                              global_batch, process_count,
                                              process_index)
    from cuda_surf_tpu_torch.parallel.mesh import psum
    local = np.full((4, 16), process_index() + 1.0, np.float32)
    x = global_batch(local, mesh)
    total = psum(x.sum(), mesh)
    return dict(total=total, shard=x, count=np.int64(process_count()),
                flight_recorder_buffer=np.str_(
                    os.environ["TORCH_NCCL_TRACE_BUFFER_SIZE"]),
                index=np.int64(process_index()), size=np.int64(mesh.size),
                gathered=all_processes_value(total, mesh))


TASKS = dict(ba=task_ba, posegraph=task_posegraph, batch=task_batch,
             sequence=task_sequence, elastic=task_elastic,
             multihost=task_multihost)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("task", choices=sorted(TASKS))
    ap.add_argument("inputs")
    ap.add_argument("out_dir")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default="gloo")
    args = ap.parse_args()
    torch.set_num_threads(1)
    from cuda_surf_tpu_torch.parallel import global_mesh, initialize_from_env
    from cuda_surf_tpu_torch.parallel.mesh import default_device
    rank = int(os.environ["SURF_PROCESS_ID"])
    device = default_device(rank) if args.device == "cuda" else \
        torch.device(args.device)
    if not initialize_from_env(timeout_s=120, backend=args.backend,
                               device=device):
        raise RuntimeError("the SURF_* launch contract is not set")
    mesh = global_mesh()
    inp = dict(np.load(args.inputs, allow_pickle=False))
    res = TASKS[args.task](mesh, inp)
    res = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
           for k, v in res.items()}
    np.savez(os.path.join(args.out_dir, f"rank{mesh.rank}.npz"),
             backend=np.str_(mesh.backend), device=np.str_(str(mesh.device)),
             **res)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
