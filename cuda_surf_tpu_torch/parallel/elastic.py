"""Liveness for long-running jobs (port of the `Heartbeat` part of
cuda_surf_tpu/parallel/elastic.py; numpy and files only).

`Heartbeat` is a daemon thread that atomically publishes `{step, time,
pid, process_index}` to a file at a fixed cadence.  An external watchdog
(or another host) reads it to detect a dead or wedged process;
`Heartbeat.stalled()` is the same check in-process.  The recovery path is
an external restart that resumes from the newest complete checkpoint
(`slam.sequence.run_sequence(..., checkpoint_dir=)`).  `CheckpointDir` and
`run_elastic` wait for the multi-device slice.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import torch


def _process_index() -> int:
    """This process's rank in the torch.distributed group, 0 without one."""
    try:
        if torch.distributed.is_available() and \
                torch.distributed.is_initialized():
            return torch.distributed.get_rank()
    except Exception:
        pass
    return 0


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
