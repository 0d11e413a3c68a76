"""The port's multi-process runtime (cuda_surf_tpu_torch/parallel/
multihost.py) and its dry run (parallel/dryrun.py), on the CPU over gloo.

Two ranks formed by `initialize_from_env` from the SURF_* contract (the
port's launcher sets it, with a free port, and kills every rank on a
failure or a timeout) all-reduce their own rows, as tests/multihost_worker.py
does across JAX processes: each rank feeds 4 rows of 16 values rank + 1
through `global_batch`, and the sum over both is (1 + 2) x 4 x 16 = 192 on
each, exactly.  The incomplete contract raises with the JAX package's
wording.  `dryrun_multichip` runs through the launcher at two CPU ranks
and in this process at a world of one; its BA must lower the cost.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from cuda_surf_tpu.parallel import multihost as jmh

from cuda_surf_tpu_torch.parallel import multihost as tmh
from cuda_surf_tpu_torch.parallel.dryrun import dryrun_multichip
from torch_parity import one_torch_thread, run_ranks  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_ranks_all_reduce_their_rows(tmp_path, monkeypatch):
    monkeypatch.delenv("TORCH_NCCL_TRACE_BUFFER_SIZE", raising=False)
    ranks = run_ranks("multihost", 2, tmp_path, {})
    for r, res in enumerate(ranks):
        assert str(res["backend"]) == "gloo" and str(res["device"]) == "cpu"
        # torch's flight recorder is off unless the environment sets it
        assert str(res["flight_recorder_buffer"]) == "0"
        assert (int(res["count"]), int(res["index"]), int(res["size"])) \
            == (2, r, 2)
        np.testing.assert_array_equal(res["shard"],
                                      np.full((4, 16), r + 1.0, np.float32))
        assert float(res["total"]) == 192.0
        np.testing.assert_array_equal(res["gathered"], [192.0, 192.0])


def test_contract_is_all_three_variables_or_none(monkeypatch):
    for k in ("SURF_COORDINATOR", "SURF_NUM_PROCESSES", "SURF_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert not tmh.multiprocess_env()
    assert tmh.initialize_from_env(device="cpu") is False
    assert (tmh.process_count(), tmh.process_index()) == (1, 0)
    monkeypatch.setenv("SURF_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("SURF_PROCESS_ID", "0")
    msgs = []
    for mod in (jmh, tmh):
        with pytest.raises(RuntimeError) as e:
            mod.initialize_from_env()
        msgs.append(str(e.value))
    want = ("SURF_COORDINATOR is set but the launch contract is "
            "incomplete: missing SURF_NUM_PROCESSES")
    assert msgs[0].startswith(want) and msgs[1].startswith(want)


def _detail(out, rank):
    m = re.search(rf"^\[rank {rank}\] dryrun detail: (.*)$", out, re.M)
    assert m, out
    return json.loads(m.group(1))


def test_dryrun_launcher_two_cpu_ranks():
    p = subprocess.run(
        [sys.executable, "-m", "cuda_surf_tpu_torch.parallel.dryrun",
         "--nproc", "2", "--backend", "gloo", "--device", "cpu",
         "--timeout", "200"], cwd=ROOT, capture_output=True, text=True,
        timeout=240)
    assert p.returncode == 0, p.stdout + p.stderr
    d0, d1 = _detail(p.stdout, 0), _detail(p.stdout, 1)
    assert d0 == d1                      # every number replicated, bit-equal
    assert d0["n_devices"] == 2 and d0["backend"] == "gloo"
    assert len(d0["counts"]) == 2 and min(d0["counts"]) > 0
    assert d0["ba_cost"] < d0["ba_cost0"]
    assert np.isfinite(d0["posegraph_cost"])
    for r in (0, 1):
        assert re.search(rf"^\[rank {r}\] dryrun_multichip\(2\): frontend "
                         r"counts=\[\d+, \d+\], BA cost=[\d.]+, posegraph "
                         r"cost=[\d.]+$", p.stdout, re.M), p.stdout


def test_dryrun_world_of_one_in_process():
    d = dryrun_multichip(1, full_res=False, device="cpu")
    assert d["n_devices"] == 1 and d["backend"] is None
    assert len(d["counts"]) == 1 and d["counts"][0] > 0
    assert d["ba_cost"] < d["ba_cost0"]
    assert np.isfinite(d["posegraph_cost"])
