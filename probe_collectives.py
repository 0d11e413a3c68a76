"""Host cost of the all-reduces of the port's `psum` at a world of one, on
one NVIDIA GPU: bare, and inside the distributed pose graph's CG.

The distributed pose graph makes one all-reduce a CG round.  In a process
group of one rank formed by `initialize_from_env` this probe reads, on
the CG's matvec buffer (3600 float32, 14.4 KB):

  - `idle_us`: host µs a bare call with the device idle;
  - `queued_us`: host µs a bare call made right behind ~1 ms of queued
    device work (`torch.cuda._sleep`), against `queued_add_us`, an
    in-place add in the same place: a call that waits for the device
    reads ~1000;
  - `device_us`: CUDA-event µs a bare call with the device idle;

and on the n = 600 SE(3) CG graph of golden_posegraph.npz (chip_smoke.py's
`multidevice` input), one Gauss-Newton step of `optimize(solver="cg")` and
of `optimize_distributed` timed in turns (single, mesh, mesh, single) with
CUDA events (`single_ms`, `mesh_ms`, medians), and, in one more step, the
host µs spent inside `torch.distributed.all_reduce`, summed and a call
(`step_allreduces`, `step_allreduce_us`).

Each variant runs in a process of its own (the group reads its settings
at set-up): NCCL and gloo as the port forms them (torch's flight
recorder off), and with the flight recorder on, alone and beside other
settings of torch and NCCL (VARIANTS).  `--repeat` runs the list that
many times.  One JSON object a variant, then the card:

    python3 probe_collectives.py [--calls 300] [--rounds 3] [--repeat 1]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

# torch's default flight recorder, which initialize_from_env turns off
# unless the environment sets it
FR_ON = {"TORCH_NCCL_TRACE_BUFFER_SIZE": "2000"}
# name -> (backend, extra environment)
VARIANTS = {
    "nccl": ("nccl", {}),
    "nccl_flight_recorder": ("nccl", FR_ON),
    "nccl_flight_recorder_no_watchdog_checks": (
        "nccl", dict(FR_ON, TORCH_NCCL_ASYNC_ERROR_HANDLING="0",
                     TORCH_NCCL_ENABLE_MONITORING="0")),
    "nccl_flight_recorder_avoid_record_streams": (
        "nccl", dict(FR_ON, TORCH_NCCL_AVOID_RECORD_STREAMS="1")),
    "nccl_flight_recorder_no_local_register": (
        "nccl", dict(FR_ON, NCCL_LOCAL_REGISTER="0")),
    "gloo": ("gloo", {}),
    "gloo_flight_recorder": ("gloo", FR_ON),
}
SLEEP_CYCLES = 2_000_000          # ~1 ms at the H100's ~1.98 GHz
CHAIN = 48                        # ~ the operations of one CG round


def graph_600():
    import numpy as np
    from chip_smoke import DATA, posegraph_case
    g = np.load(os.path.join(DATA, "golden_posegraph.npz"))
    return posegraph_case(g, "se3_600")[1]


def one_variant(name: str, calls: int, rounds: int) -> dict:
    import statistics
    import torch.distributed as dist
    from cuda_surf_tpu_torch.parallel import global_mesh, initialize_from_env
    from cuda_surf_tpu_torch.parallel.dryrun import free_port
    from cuda_surf_tpu_torch.parallel.mesh import psum
    from cuda_surf_tpu_torch.slam import posegraph
    backend = VARIANTS[name][0]
    os.environ.update(SURF_COORDINATOR=f"127.0.0.1:{free_port()}",
                      SURF_NUM_PROCESSES="1", SURF_PROCESS_ID="0")
    initialize_from_env(backend=backend, device="cuda:0")
    mesh = global_mesh()
    x = torch.ones(3600, device="cuda")
    call = lambda: psum(x, mesh)
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    idle = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()

    def behind_queue(fn):
        total = 0.0
        for _ in range(calls // 10):
            torch.cuda._sleep(SLEEP_CYCLES)
            t = time.perf_counter()
            fn()
            total += time.perf_counter() - t
            torch.cuda.synchronize()
        return total / (calls // 10) * 1e6
    queued = behind_queue(call)
    queued_add = behind_queue(lambda: x.add_(0.0))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        call()
    b.record()
    b.synchronize()
    device = a.elapsed_time(b) * 1e3 / calls

    g = graph_600()
    steps = dict(
        single=lambda: posegraph.optimize(g, n_iters=1, solver="cg"),
        mesh=lambda: posegraph.optimize_distributed(g, mesh, n_iters=1))
    ms = {k: [] for k in steps}
    for fn in steps.values():
        fn()
    for _ in range(rounds):
        for k in ("single", "mesh", "mesh", "single"):
            a.record()
            steps[k]()
            b.record()
            b.synchronize()
            ms[k].append(a.elapsed_time(b))
    spent = []
    bare = dist.all_reduce

    def timed(*args, **kw):
        t = time.perf_counter()
        out = bare(*args, **kw)
        spent.append(time.perf_counter() - t)
        return out
    dist.all_reduce = timed
    try:
        steps["mesh"]()
    finally:
        dist.all_reduce = bare
    torch.cuda.synchronize()
    dist.destroy_process_group()
    return dict(variant=name, backend=backend, env=VARIANTS[name][1],
                flight_recorder_buffer=os.environ[
                    "TORCH_NCCL_TRACE_BUFFER_SIZE"],
                calls=calls, idle_us=idle, queued_us=queued,
                queued_add_us=queued_add, device_us=device,
                single_ms=statistics.median(ms["single"]),
                mesh_ms=statistics.median(ms["mesh"]),
                runs=2 * rounds, step_allreduces=len(spent),
                step_allreduce_us=sum(spent) * 1e6,
                step_allreduce_us_each=sum(spent) * 1e6 / len(spent),
                nccl=".".join(map(str, torch.cuda.nccl.version())),
                torch=torch.__version__)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--variant", choices=sorted(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_collectives: no CUDA device", file=sys.stderr)
        return 2
    if args.variant:
        print(json.dumps(one_variant(args.variant, args.calls, args.rounds)),
              flush=True)
        return 0
    for name, (_, env) in list(VARIANTS.items()) * args.repeat:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--variant", name,
             "--calls", str(args.calls), "--rounds", str(args.rounds)],
            env=dict(os.environ, **env),
            capture_output=True, text=True, timeout=300)
        if out.returncode:
            raise RuntimeError(f"{name}: exit {out.returncode}\n{out.stderr}")
        print(out.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
