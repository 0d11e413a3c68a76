"""Request forms: how a mix's requests drive the program, and how a
sampled request is judged.  A mix names its form (`"request": "<name>"`
in `traffic/<mix>.json`); `forms/<name>.py` holds

- `Requests(lib, cfg, inputs, device)`: called with a request's index,
  it serves the request and returns its `Outputs`, still on the device.
  `lib` is the package that serves: `cuda_surf_tpu_torch`, or for the
  control the plain reference, which has the same entry points.  It may
  keep `held`, outputs that the check needs beyond the sample, and a
  `close()`;
- `judge(j, acc, i, out)`: the numbers of sampled request i against the
  reference (`reference.judge.Judge` j), into `acc`;
- optionally `judge_held(j, acc, held)`: the numbers of what it held.

A new form is a new file here.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class Outputs:
    kps: list                # Keypoints a frame (batch: one with (B, N) fields)
    descs: list
    matches: list            # Matches a matched pair (batch: (B-1, N) fields)
    track: Any = None        # frame: the pair's TrackResult
    state: Any = None        # frame: the FrameState returned
    prev_kps: Any = None     # frame: the Keypoints it was tracked from


def one(t, b):
    """Row b of a NamedTuple of batched fields."""
    return type(t)(*[f[b] for f in t])
