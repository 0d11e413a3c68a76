"""A sequence on a mesh: `ranks` processes, one card each, serve every
request together through `BatchSurf(mesh=)`.  Each rank detects and
describes its frames / ranks frames in one stacked call and the batch is
all-gathered; each rank matches the pairs i -> i + 1 that start in its
frames and the matches are all-gathered; rank 0 reads the counts and
matches back, as the `batch` form does.

Rank 0 is the harness's process, on the card it was given (cuda:0).  It
starts ranks 1 .. ranks - 1 (`portbench/mesh_worker.py`) on cuda:1 ..,
forms the process group with them through the port's launch contract
(`parallel.multihost.initialize_from_env`: NCCL; gloo and CPU ranks on the
CPU), broadcasts the input pool to them once, and writes each request's
index to their standard input.  A worker that exits ends the run at once
(rank 0's watchdog kills the others and exits), as does a request that
fails on rank 0 (the ranks are then out of step) and rank 0's exit
without `close()`; a worker ends itself when rank 0's process is gone;
the process group's timeout ends a collective that hangs.

Under the control the plain reference serves the whole sequence on one
card, as the `batch` form does.  The check is the `batch` form's, over
every frame and pair of the sampled requests.
"""

from __future__ import annotations

import atexit
import json
import os
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from ..reference import surfref
from . import Outputs, batch
from .batch import judge  # noqa: F401  (this form's check)

ROOT = Path(__file__).resolve().parents[2]
TIMEOUT_S = 45           # the process group's: joining, and any collective

# the ranks and frames a request of the mesh last served, which the
# per-layer readers of the collectives need
LAYOUT: dict = {}


def serve(bs, frames):
    """One request on one rank: the mesh's detect + describe of the
    sequence, then its pairs i -> i + 1."""
    kps, descs = bs.detect_and_compute(frames)
    return kps, descs, bs.match_sequence(kps, descs)


class Requests:
    def __init__(self, lib, cfg: dict, inputs, device):
        self.inputs, self.workers, self.closing = inputs, [], False
        self.control = batch.Requests(lib, cfg, inputs, device) \
            if lib is surfref else None
        if self.control is not None:
            return
        if not hasattr(lib.BatchSurf, "match_sequence"):
            raise RuntimeError("mesh form: this program's BatchSurf has no "
                               "match_sequence")
        from cuda_surf_tpu_torch.parallel import (initialize_from_env,
                                                  make_mesh)
        from cuda_surf_tpu_torch.parallel.dryrun import free_port
        n, on_card = inputs.mix["ranks"], device.type == "cuda"
        if on_card:
            device = torch.device("cuda", torch.cuda.current_device())
        backend = "nccl" if on_card else "gloo"
        contract = dict(SURF_COORDINATOR=f"127.0.0.1:{free_port()}",
                        SURF_NUM_PROCESSES=str(n))
        part = dict(surf=cfg["surf"], mix=inputs.mix, backend=backend,
                    pool_shape=list(inputs.frames.shape),
                    timeout_s=TIMEOUT_S, parent=os.getpid())
        atexit.register(self._end)
        for r in range(1, n):
            part["device"] = f"cuda:{r}" if on_card else "cpu"
            self.workers.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.mesh_worker",
                 json.dumps(part)], cwd=ROOT, text=True,
                env=dict(os.environ, **contract, SURF_PROCESS_ID=str(r)),
                stdin=subprocess.PIPE, stdout=subprocess.DEVNULL))
        threading.Thread(target=self._watch, daemon=True).start()
        os.environ.update(contract, SURF_PROCESS_ID="0")
        try:
            initialize_from_env(timeout_s=TIMEOUT_S, backend=backend,
                                device=device)
        finally:
            for k in (*contract, "SURF_PROCESS_ID"):
                del os.environ[k]
        dist.broadcast(inputs.frames.contiguous(), src=0)
        self.bs = lib.BatchSurf(lib.SurfConfig(**cfg["surf"]), device.type,
                                mesh=make_mesh())
        LAYOUT.update(ranks=n, frames=inputs.frames_per_request())

    def __call__(self, i: int) -> Outputs:
        if self.control is not None:
            return self.control(i)
        try:
            for w in self.workers:
                w.stdin.write(f"{i}\n")
                w.stdin.flush()
            kp, d, m = serve(self.bs, self.inputs.frames_of(i))
            torch.cat([kp.count.float(), m.score.reshape(-1),
                       m.index.reshape(-1).float()]).cpu()
        except Exception:       # the ranks are out of step: end the run
            traceback.print_exc()
            print(f"mesh form: request {i} failed; ending the run",
                  file=sys.stderr)
            self._end()
        return Outputs([kp], [d], [m])

    def _watch(self):
        """Ends the run when a worker exits before `close()`."""
        while not self.closing:
            for r, w in enumerate(self.workers, 1):
                if w.poll() is not None and not self.closing:
                    print(f"mesh form: rank {r} exited with code "
                          f"{w.returncode}; ending the run", file=sys.stderr)
                    self._end()
            time.sleep(0.2)

    def _end(self):
        """Kill the workers and leave at once, exit code 1: the group is
        not destroyed, as NCCL's teardown waits for every rank, and the
        main thread may be waiting in a collective."""
        self.closing = True
        for w in self.workers:
            if w.poll() is None:
                w.kill()
            w.wait()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)

    def close(self):
        """Stop the workers; every rank destroys the group together (NCCL's
        teardown waits for all of them)."""
        if self.control is not None or self.closing:
            return
        self.closing = True
        for w in self.workers:
            w.stdin.write("stop\n")
            w.stdin.close()
        dist.destroy_process_group()
        for w in self.workers:
            try:
                w.wait(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                w.kill()
                w.wait()
        atexit.unregister(self._end)
