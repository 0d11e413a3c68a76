"""Tiny sizes at which a cell runs on the CPU in a test (the program then
runs its plain twins)."""

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TINY_SURF = {"frame": {"h": 96, "w": 128},
             "surf": {"max_pts": 256, "candidates_per_octave": 256,
                      "noctaves": 3},
             "mix": {"pool": 2, "sample": 2, "trace_requests": 2}}
TINY = {
    "surf_demo.pairs": TINY_SURF,
    "surf_demo.batch32": dict(TINY_SURF, mix=dict(TINY_SURF["mix"], frames=3)),
    "vo_tum.orbit": {"frame": {"h": 200, "w": 280},
                     "mix": {"lap": 12, "start_frames": 6, "sample": 2,
                             "draws": 64, "trace_requests": 1}},
}


def tiny_run(workload, seed=11, seconds=1.0, **kw):
    from portbench import run
    return run.run(workload, seed, seconds, kw.pop("trace", False),
                   device="cpu", root=ROOT, overrides=TINY[workload], **kw)
