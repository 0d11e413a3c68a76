"""The one generator of the benchmark's traffic: reads a mix's data file,
`traffic/<mix>.json`, and makes every input of a run on the device from
`--seed`.

A mix is data.  It names its `scene` (`scenes/<scene>.py`, which makes the
frames and draws), its `request` form (`forms/<request>.py`, which drives
the program and judges a sampled request), and sizes them; the rest of
its keys are read by the harness:

- `warmup`: requests sent in set-up to warm every shape the mix uses;
- `sample`: requests of the window drawn from the seed for the check;
- `trace_requests`: requests in the traced block of a `--trace 1` run.

The same seed gives the same inputs; every seed gives the same sizes.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def part(kind: str, name: str):
    """The module `<kind>/<name>.py` that a mix names (`scenes`, `forms`)."""
    return importlib.import_module(f"{__package__}.{kind}.{name}")


def make_inputs(mix: dict, frame: dict, seed: int, device):
    """All of a run's inputs, from the seed, on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return part("scenes", mix["scene"]).make_inputs(mix, frame, gen, device)
