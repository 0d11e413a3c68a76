"""The port's `CheckpointDir` and `run_elastic` (cuda_surf_tpu_torch/
parallel/elastic.py) against the JAX package's on the same step function:
tests/test_elastic.py's cases, each run by both packages in directories of
their own, must give the same state, the same restarts, the same error
and the same checkpoint steps; and a two-rank resume over gloo
(tests/torch_multidevice_worker.py) on checkpoint directories that
disagree, where every rank resumes at one step.  Everything is integer
state, so every comparison is exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from cuda_surf_tpu.parallel import elastic as jel

from cuda_surf_tpu_torch.parallel import elastic as tel
from torch_parity import run_ranks

PACKAGES = {"jax": jel, "port": tel}


def _stepper():
    """Deterministic state update: x_{k+1} = 3 x_k + k (mod 2^31)."""
    def step(k, state):
        return {"x": (np.asarray(state["x"]) * 3 + k) % (2 ** 31)}
    return step


def _plain(n):
    ref = {"x": np.int64(1)}
    for k in range(n):
        ref = _stepper()(k, ref)
    return int(ref["x"])


def test_checkpoint_dir_matches_jax(tmp_path):
    """Round trip, prune at keep=2, a torn write ignored, a sibling prefix
    kept apart; each package reads the other's files."""
    seen = {}
    for name, mod in PACKAGES.items():
        d = str(tmp_path / name)
        ck = mod.CheckpointDir(d, keep=2)
        assert ck.load_latest() == (-1, None)
        for s in (3, 7, 12):
            ck.save(s, {"x": np.full(4, s), "k": np.int64(s)})
        with open(os.path.join(d, "elastic_000000019.npz.tmp.123"),
                  "wb") as f:
            f.write(b"garbage")
        mod.CheckpointDir(d, prefix="elastic_fine").save(40, {"x": 0})
        step, state = ck.load_latest()
        seen[name] = (ck.steps(), step, state, ck.load(3), ck.load(7))
    jax_seen, port_seen = seen["jax"], seen["port"]
    assert port_seen[:2] == jax_seen[:2] == ([7, 12], 12)
    for a, b in zip(port_seen[2:], jax_seen[2:]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    # the same files: each package loads the other's
    for mine, other in (("port", "jax"), ("jax", "port")):
        step, state = PACKAGES[mine].CheckpointDir(
            str(tmp_path / other)).load_latest()
        assert step == 12 and int(state["k"]) == 12
    # the port saves tensors from the host
    ck = tel.CheckpointDir(str(tmp_path / "tensor"))
    ck.save(1, {"x": torch.arange(3)})
    np.testing.assert_array_equal(ck.load(1)["x"], np.arange(3))


def _scenario(name, mod, d):
    """One of tests/test_elastic.py's run_elastic cases on one package ->
    (result or exception text, restarts, checkpoint steps)."""
    ck = mod.CheckpointDir(d)
    base = _stepper()
    restarts = []
    kw = dict(ckpt=ck, on_restart=lambda k, e: restarts.append(k))
    if name == "plain":
        out = mod.run_elastic(base, {"x": np.int64(1)}, n_steps=25,
                              ckpt_every=10, **kw)
    elif name == "transient":
        fail = {13, 17}

        def step(k, state):
            if k in fail:
                fail.discard(k)
                raise RuntimeError(f"injected failure at {k}")
            return base(k, state)
        out = mod.run_elastic(step, {"x": np.int64(1)}, n_steps=30,
                              ckpt_every=5, max_restarts=3, **kw)
    elif name == "give_up":
        def always_fail(k, state):
            raise RuntimeError("permanent")
        with pytest.raises(RuntimeError, match="permanent") as e:
            mod.run_elastic(always_fail, {"x": np.int64(0)}, n_steps=5,
                            max_restarts=2, **kw)
        out = {"x": str(e.value)}
    else:                   # "resume": a killed process, then a new one
        class Kill(Exception):
            pass

        def step(k, state):
            if k == 22:
                raise Kill()
            return base(k, state)
        with pytest.raises(Kill):
            mod.run_elastic(step, {"x": np.int64(1)}, n_steps=40,
                            ckpt_every=10, max_restarts=0, ckpt=ck)
        out = mod.run_elastic(base, {"x": np.int64(1)}, n_steps=40,
                              ckpt=ck, ckpt_every=10)
    return out["x"], restarts, ck.steps()


@pytest.mark.parametrize("name, n_steps", [("plain", 25), ("transient", 30),
                                           ("give_up", None),
                                           ("resume", 40)])
def test_run_elastic_matches_jax(name, n_steps, tmp_path):
    jx, jr, js = _scenario(name, jel, str(tmp_path / "jax"))
    px, pr, ps = _scenario(name, tel, str(tmp_path / "port"))
    assert (px, pr, ps) == (jx, jr, js)
    if n_steps is not None:
        assert int(px) == _plain(n_steps)
    if name == "transient":
        assert pr == [13, 17]


def test_two_rank_resume_takes_rank0_step(tmp_path):
    """Each rank on a checkpoint directory of its own (a file system that
    is not shared); every rank must resume at the same step.  "ahead":
    rank 0 holds steps 9 and 19, rank 1 also 29; both resume at rank 0's
    step 20.  "behind": rank 1 holds step 9 only; it takes rank 0's step
    and rank 0's state, and both resume at 20 (the JAX reference restarts
    such a rank at step 0 while rank 0 resumes: ROADMAP Queue 3).
    "local_behind", host-local state (`all_processes`, a checkpoint
    namespace a rank): rank 0 holds 9 and 19, rank 1 only 9; no rank can
    take another's state, so both resume after the newest step both hold,
    at 10.  Every case ends on the plain loop's state on both ranks, and
    only the saver writes the final checkpoint."""
    states = {}
    x = {"x": np.int64(1)}
    for k in range(30):
        x = _stepper()(k, x)
        states[k] = x
    held = {"ahead": ((9, 19), (9, 19, 29)), "behind": ((9, 19), (9,)),
            "local_behind": ((9, 19), (9,))}
    first = {"ahead": 20, "behind": 20, "local_behind": 10}
    inputs = dict(scenarios=np.str_(json.dumps(list(held))),
                  n_steps=np.int64(40), local_behind_all_processes=True)
    for sc, per_rank in held.items():
        for rank, steps in enumerate(per_rank):
            d = tmp_path / f"{sc}_{rank}"
            prefix = "elastic" if rank == 0 or sc != "local_behind" \
                else f"elastic.p{rank}"
            ck = tel.CheckpointDir(str(d), prefix=prefix)
            for s in steps:
                ck.save(s, states[s])
            inputs[f"{sc}_dir_{rank}"] = np.str_(str(d))
    r0, r1 = run_ranks("elastic", 2, tmp_path, inputs)
    for sc in held:
        for r in (r0, r1):
            assert int(r[f"{sc}_x"]) == _plain(40)
            np.testing.assert_array_equal(r[f"{sc}_ran"],
                                          np.arange(first[sc], 40))
    assert tel.CheckpointDir(str(tmp_path / "ahead_0")).steps()[-1] == 39
    assert tel.CheckpointDir(str(tmp_path / "ahead_1")).steps()[-1] == 29
    assert tel.CheckpointDir(str(tmp_path / "behind_1")).steps() == [9]
    assert tel.CheckpointDir(str(tmp_path / "local_behind_1"),
                             prefix="elastic.p1").steps()[-1] == 39
