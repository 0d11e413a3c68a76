"""Structured per-frame metrics logging (copy of
cuda_surf_tpu/utils/metrics.py, which is numpy- and jax-free but lives in
the JAX package, whose import imports jax).

Keypoint counts, match inliers, keyframe decisions, collected as
structured records, dumpable as JSON lines.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, List


class MetricsLogger:
    def __init__(self, stream=None, echo: bool = False):
        self.records: List[Dict[str, Any]] = []
        self.stream = stream
        self.echo = echo
        self._t0 = time.perf_counter()

    def log(self, **fields):
        rec = {"t": round(time.perf_counter() - self._t0, 6), **fields}
        self.records.append(rec)
        if self.echo:
            print(json.dumps(rec), file=self.stream or sys.stderr)

    def dump(self, path: str):
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"n_records": len(self.records)}
        for key in ("keypoints", "inliers"):
            vals = [r[key] for r in self.records if key in r]
            if vals:
                out[f"{key}_mean"] = sum(vals) / len(vals)
        return out
