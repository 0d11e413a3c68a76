"""The `mesh` request form (`surf_demo.mesh4`) on the CPU: rank 0 and its
worker ranks as gloo processes at a tiny size.  A run reports
`frames_per_s` and is correct; the control is not; a run whose worker is
killed in the window, or whose rank 0 raises after starting its workers,
ends within 60 s and leaves no process behind."""

import json
import os
import signal
import subprocess
import sys
import time

from portbench.tests.helpers import ROOT, TINY_SURF

CELL = "surf_demo.mesh4"
TINY = dict(TINY_SURF, mix={"pool": 2, "frames": 6, "ranks": 3, "sample": 1,
                            "trace_requests": 1})
RUN = ("import json, sys\n"
       "from portbench import run\n"
       "from portbench.tests.helpers import ROOT\n"
       "line = run.run({cell!r}, 2 ** 31 + 9, {seconds}, False, "
       "device='cpu', root=ROOT, overrides=json.loads(sys.argv[1]))\n"
       "print(json.dumps(line), flush=True)\n")


def test_cell_runs_the_demo_surf_on_its_own_cluster():
    """The cell's configuration is the four-card deployment: the demo's
    SURF settings and frames (so batch32's limits hold each frame), a
    cluster of the mix's ranks, one card a rank."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(c for c in bench["workloads"] if c["name"] == CELL)
    files = {c["name"]: c["file"] for c in bench["configs"]}
    conf = json.loads((ROOT / files[cell["config"]]).read_text())
    demo = json.loads((ROOT / files["surf_demo"]).read_text())
    mix = json.loads((ROOT / "portbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    assert cell["config"] != "surf_demo" and cell["chips"] == 4
    assert conf["surf"] == demo["surf"] and conf["frame"] == demo["frame"]
    assert conf["cluster"]["ranks"] == mix["ranks"] == cell["chips"]
    assert conf["cluster"]["gpus_per_rank"] == 1


def _children(pid: int) -> list:
    """The processes whose parent is `pid`."""
    out = []
    for d in os.listdir("/proc"):
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        if d.isdigit() and int(fields[1]) == pid:
            out.append(int(d))
    return out


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _start(code: str):
    return subprocess.Popen([sys.executable, "-c", code, json.dumps(TINY)],
                            cwd=ROOT, stdout=subprocess.PIPE, text=True)


def _workers_of(proc, timeout=120.0) -> list:
    """Rank 0's worker processes, once they have all started."""
    t0 = time.time()
    while time.time() < t0 + timeout:
        kids = _children(proc.pid)
        if len(kids) == TINY["mix"]["ranks"] - 1:
            return kids
        time.sleep(0.2)
    raise AssertionError("the workers never started")


def test_tiny_mesh_run_is_correct():
    proc = _start(RUN.format(cell=CELL, seconds=1.5))
    workers = _workers_of(proc)
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["metrics"]["frames_per_s"]["value"] > 0
    assert "setup_s" in line["metrics"]
    assert not any(map(_alive, workers))


def test_control_is_not_correct():
    from portbench import run
    line = run.run(CELL, 7, 1.0, False, device="cpu", root=ROOT,
                   overrides=TINY, control=True, log=lambda *a, **k: None)
    assert not line["correct"], line["checks"]


def test_killed_worker_ends_the_run():
    proc = _start(RUN.format(cell=CELL, seconds=120))
    for ln in proc.stdout:              # set-up done: the window runs
        if ln.startswith("setup "):
            break
    workers = _workers_of(proc)
    time.sleep(1.0)
    os.kill(workers[0], signal.SIGKILL)
    t0 = time.time()
    proc.wait(timeout=60)
    assert time.time() - t0 < 60 and proc.returncode != 0
    time.sleep(0.5)
    assert not any(map(_alive, workers))


def test_rank0_failure_leaves_no_worker():
    """Rank 0 raises after its workers have joined: it exits with the
    error, and its exit kills them."""
    code = ("import json, sys, torch\n"
            "from portbench import traffic\n"
            "from portbench.forms import mesh\n"
            "import cuda_surf_tpu_torch as lib\n"
            "tiny = json.loads(sys.argv[1])\n"
            "cfg = {'surf': dict(json.load(open('portbench/configs/"
            "surf_mgpu4.json'))['surf'], **tiny['surf'])}\n"
            "mix = dict(traffic.load_mix('mesh4'), **tiny['mix'])\n"
            "inputs = traffic.make_inputs(mix, tiny['frame'], 3, 'cpu')\n"
            "call = mesh.Requests(lib, cfg, inputs, torch.device('cpu'))\n"
            "call(0)\n"
            "raise RuntimeError('rank 0 fails')\n")
    proc = _start(code)
    workers = _workers_of(proc)
    proc.wait(timeout=60)
    assert proc.returncode != 0
    time.sleep(0.5)
    assert not any(map(_alive, workers))
