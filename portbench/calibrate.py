"""Readings for the limits of a cell's correctness check, in one process:
the program's numbers on a dozen seeds or more, the control's (the plain
reference at TF32 in the program's place) on three or more, and each
planted fault's (`faults.py`) that the cell's request form can have, each
over a short window at the cell's own load and size.  Not part of a
benchmark run.

    python3 -m portbench.calibrate --workload <cell> --seconds 4 \
        --seeds 1,2,...,12 --control-seeds 101,102,103 \
        --fault-seeds 201,202,203 [--faults keypoint_moved,...]

Prints one JSON line a run, then, for each side (the program, the
control, each fault), the least and the largest reading of each number.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

from . import faults, run, traffic


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="",
                    help="comma-separated; default: every fault of the form")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    quiet = lambda *x, **k: None
    cell, _ = run.cell_spec(run.load_bench(Path(".")), a.workload)
    form = traffic.load_mix(cell["traffic"])["request"]
    sides = [("program", a.seeds, None), ("control", a.control_seeds, None)]
    sides += [(f, a.fault_seeds, faults.FAULTS[f][0])
              for f in faults.of_form(form)
              if not a.faults or f in a.faults.split(",")]
    seen = {}
    for side, seeds, plant in sides:
        for s in filter(None, seeds.split(",")):
            with plant() if plant else contextlib.nullcontext():
                line = run.run(a.workload, int(s), a.seconds, False,
                               device=a.device, control=side == "control",
                               log=quiet)
            nums = {k: c["value"] for k, c in line["checks"].items()}
            print(json.dumps({"workload": a.workload, "side": side,
                              "seed": int(s), "correct": line["correct"],
                              "attempted": line["attempted"],
                              "numbers": nums}), flush=True)
            for k, v in nums.items():
                seen.setdefault(side, {}).setdefault(k, []).append(v)
    key = lambda v: float("inf") if v is None else v
    print(json.dumps({"workload": a.workload, "card": run.card_line(),
                      "readings": {side: {k: [min(v, key=key),
                                              max(v, key=key)]
                                          for k, v in nums.items()}
                                   for side, nums in seen.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
