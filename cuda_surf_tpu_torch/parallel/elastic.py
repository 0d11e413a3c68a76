"""Failure detection and elastic recovery for long-running jobs (port of
cuda_surf_tpu/parallel/elastic.py; numpy and files, and one broadcast on
the process group).

A lost rank or a wedged collective takes the whole process group down (or
hangs it), so the recovery path is *external restart + resume from the
newest complete checkpoint*, not in-place retry of a device call:

  - `Heartbeat` — a daemon thread that atomically publishes
    `{step, time, pid, process_index}` to a file at a fixed cadence.  An
    external watchdog (or another host) reads it to detect a dead or
    wedged process; `Heartbeat.stalled()` is the same check in-process.
  - `CheckpointDir` — atomic (write-temp + rename), step-numbered npz
    checkpoints with newest-complete discovery and pruning.  A torn write
    is invisible: the temp file is never renamed.
  - `run_elastic` — a step loop: checkpoint every N steps, beat every
    step, and on a step failure restore the newest checkpoint and go on
    (bounded retries).  Re-running the same call after an external
    restart resumes from the same checkpoints.  In a process group every
    rank resumes at the same step: rank 0's (one broadcast).  A rank that
    lacks that checkpoint takes rank 0's state when the state is
    replicated; for host-local state every rank falls back to the newest
    step all of them hold.

`slam.sequence.run_sequence(..., checkpoint_dir=)` checkpoints the SLAM
pipeline itself.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import rank_device


def _process_index() -> int:
    """This process's rank in the torch.distributed group, 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


class Heartbeat:
    """Atomically publishes liveness+progress to `path` every
    `interval` seconds from a daemon thread; `beat(step)` records
    progress from the step loop."""

    def __init__(self, path: str, interval: float = 5.0,
                 stall_timeout: float = 120.0):
        self.path = path
        self.interval = interval
        self.stall_timeout = stall_timeout
        self._step = -1
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- publishing ----------------------------------------------------
    def _write(self):
        payload = {
            "step": self._step,
            "time": time.time(),
            "monotonic": time.monotonic(),
            "pid": os.getpid(),
            "process_index": _process_index(),
        }
        # thread-unique tmp: stop() writes from the main thread after a
        # join timeout, possibly while a wedged daemon thread is still
        # inside its own _write — a shared tmp name would race the
        # os.replace and raise FileNotFoundError out of stop()
        tmp = f"{self.path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)  # atomic on POSIX

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                self._write()

        self._write()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="surf-heartbeat")
        self._thread.start()
        return self

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2 * self.interval)
            self._thread = None
        self._write()

    def beat(self, step: int):
        """Record step progress (called from the main loop)."""
        self._step = step
        self._last_beat = time.monotonic()

    # -- detection -----------------------------------------------------
    def stalled(self) -> bool:
        """True when the step loop has not beaten within stall_timeout
        (the publisher thread may still be alive — a wedged collective
        keeps the process up while the loop stops progressing)."""
        return (time.monotonic() - self._last_beat) > self.stall_timeout

    @staticmethod
    def read(path: str, dead_after: float = 60.0) -> dict:
        """External watchdog view: parsed payload + `dead` flag (file
        missing or wall-clock-stale by `dead_after` seconds)."""
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            return {"dead": True, "reason": "missing-or-torn"}
        payload["dead"] = (time.time() - payload["time"]) > dead_after
        return payload


class CheckpointDir:
    """Step-numbered atomic npz checkpoints with newest-complete
    discovery.  Filenames: `<prefix>_<step>.npz`."""

    def __init__(self, directory: str, prefix: str = "elastic",
                 keep: int = 3):
        self.dir = directory
        self.prefix = prefix
        self.keep = keep
        # anchored to the FULL filename: a sibling prefix that extends
        # this one ("run" vs "run_fine") must not leak its step numbers
        # into discovery (load_latest would then open a missing path)
        self._pat = re.compile(re.escape(prefix) + r"_(\d+)\.npz\Z")
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"{self.prefix}_{step:09d}.npz")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = self._pat.fullmatch(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, step: int, state: dict[str, Any]):
        """Atomic save: a kill mid-write leaves no `.npz`, only a temp
        file that the next discovery ignores.  Tensors are saved from the
        host."""
        tmp = self._path(step) + f".tmp.{os.getpid()}"
        arrays = {k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v) for k, v in state.items()}
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, self._path(step))
        self._prune()

    def load(self, step: int):
        """State dict at `step`, or None when that checkpoint is absent."""
        if step not in self.steps():
            return None
        data = np.load(self._path(step))
        return {k: data[k] for k in data.files}

    def load_latest(self):
        """(step, state) of the newest complete checkpoint, or
        (-1, None) when none exists."""
        steps = self.steps()
        if not steps:
            return -1, None
        step = steps[-1]
        data = np.load(self._path(step))
        return step, {k: data[k] for k in data.files}

    def _prune(self):
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass


def _agree_resume(ckpt: CheckpointDir, start: int, loaded,
                  all_processes: bool):
    """(step, state) that every rank of the group resumes from; this
    rank's own without a group or at a world of one.  Rank 0's step is
    broadcast as an int64 on the rank's device.  When a rank lacks that
    checkpoint (a file system that is not shared, a torn write), every
    rank learns it from one all-reduce; then replicated state is rank 0's,
    broadcast, and host-local state (`all_processes`) restarts every rank
    from the newest step all of them hold (the initial state when none).
    A collective that fails raises."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return start, loaded
    device = rank_device()
    t = torch.tensor([start], dtype=torch.int64, device=device)
    dist.broadcast(t, src=0)
    agreed = int(t.item())
    if agreed != start:
        loaded = None if agreed < 0 else ckpt.load(agreed)
    held = torch.tensor([int(agreed < 0 or loaded is not None)],
                        dtype=torch.int64, device=device)
    dist.all_reduce(held, op=dist.ReduceOp.MIN)
    if held.item():
        return agreed, loaded
    if not all_processes:
        box = [loaded]
        dist.broadcast_object_list(box, src=0, device=device)
        return agreed, box[0]
    held_steps = [None] * dist.get_world_size()
    dist.all_gather_object(held_steps, ckpt.steps())
    common = set(held_steps[0]).intersection(*held_steps[1:])
    step = max(common, default=-1)
    return step, None if step < 0 else ckpt.load(step)


def run_elastic(step_fn: Callable[[int, dict], dict],
                init_state: dict[str, Any],
                n_steps: int,
                ckpt: CheckpointDir,
                ckpt_every: int = 10,
                max_restarts: int = 3,
                heartbeat: Optional[Heartbeat] = None,
                all_processes: bool = False,
                on_restart: Optional[Callable[[int, Exception], None]]
                = None) -> dict[str, Any]:
    """Run `state = step_fn(step, state)` for steps [0, n_steps) with
    periodic checkpointing and restore-on-failure.

    Resume semantics: if `ckpt` already holds checkpoints (from a
    previous process incarnation), the loop starts after the newest
    one — re-running the same `run_elastic` call after an external
    restart continues the job.  In-process, a step that raises is
    retried from the newest checkpoint up to `max_restarts` times
    (steps since that checkpoint are recomputed — step_fn must be
    deterministic given (step, state) for bit-stable recovery).
    A restored state holds numpy arrays.
    """
    i_am_saver = all_processes or _process_index() == 0
    if all_processes and _process_index() != 0:
        # host-local state: each process gets its own checkpoint
        # namespace, otherwise every rank writes the same filename and
        # the last writer wins (resume would feed rank 0's state — e.g.
        # a data-loader cursor — to every rank)
        ckpt = CheckpointDir(ckpt.dir,
                             f"{ckpt.prefix}.p{_process_index()}",
                             keep=ckpt.keep)
    # Multi-process resume must agree on the step: a rank whose local
    # dir is missing/behind (non-shared FS, torn write) would otherwise
    # restart at a different step and desynchronize every collective.
    start, loaded = _agree_resume(ckpt, *ckpt.load_latest(), all_processes)
    state = dict(init_state) if loaded is None else loaded
    step = start + 1
    restarts = 0
    if heartbeat is not None:
        heartbeat.start()
    try:
        while step < n_steps:
            try:
                state = step_fn(step, state)
            except Exception as e:  # noqa: BLE001 — deliberate catch-all
                restarts += 1
                if restarts > max_restarts:
                    raise
                if on_restart is not None:
                    on_restart(step, e)
                back, loaded = ckpt.load_latest()
                if loaded is None:
                    state = dict(init_state)
                    step = 0
                else:
                    state = loaded
                    step = back + 1
                continue
            if heartbeat is not None:
                heartbeat.beat(step)
            if i_am_saver and (step + 1) % ckpt_every == 0:
                ckpt.save(step, state)
            step += 1
        if i_am_saver and (start < n_steps - 1):
            ckpt.save(n_steps - 1, state)
    finally:
        if heartbeat is not None:
            heartbeat.stop()
    return state
