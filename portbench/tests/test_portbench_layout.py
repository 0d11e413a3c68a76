"""BENCHMARK.json resolves to the benchmark's files by name, keeps to the
contract's character sets, and the harness loads no JAX."""

import json
import re
import subprocess
import sys

import pytest

from portbench import run, traffic
from portbench.tests.helpers import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_name_resolves_to_its_files():
    for conf in BENCH["configs"]:
        assert (ROOT / conf["file"]).is_file()
        assert conf["file"].startswith("portbench/")
    names = {c["name"] for c in BENCH["configs"]}
    for cell in BENCH["workloads"]:
        assert cell["config"] in names
        mix = traffic.load_mix(cell["traffic"])
        assert callable(traffic.part("scenes", mix["scene"]).make_inputs)
        form = traffic.part("forms", mix["request"])
        assert callable(form.Requests) and callable(form.judge)
        assert (ROOT / "portbench" / "limits" / f"{cell['name']}.json").is_file()
        assert run.per_layer_of(BENCH, cell["name"])
    for m in BENCH["per_layer"]:
        assert callable(run.load_reader(m["name"]))
        assert set(m["workloads"]) <= {c["name"] for c in BENCH["workloads"]}
        moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert all(run.reports(moves, c) for c in m["workloads"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_names_and_limits_of_the_contract():
    items = BENCH["configs"] + BENCH["workloads"]
    for it in items:
        assert NAME.match(it["name"])
        assert 1 <= len(it["why"]) <= 200 and "\n" not in it["why"]
    for cell in BENCH["workloads"]:
        assert NAME.match(cell["traffic"]) and cell["chips"] in (1, 4)
    e2e = BENCH["end_to_end"]
    assert any(m["name"] == "setup_s" for m in e2e)
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e)
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e)
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_no_jax_in_the_harness_process():
    """A tiny cell run end to end in a fresh process: sys.modules holds
    no top-level jax, jaxlib, flax or cuda_surf_tpu (compared whole)."""
    code = ("import json\n"
            "from portbench.tests.helpers import tiny_run\n"
            "from portbench import run\n"
            "tiny_run('surf_demo.pairs', seconds=0.3, log=lambda *a, **k: None)\n"
            "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    from portbench.tests.helpers import tiny_run
    line = tiny_run("surf_demo.pairs", trace=trace,
                    log=lambda *a, **k: None)
    keys = list(line)
    need = ["correct", "attempted", "failed", "metrics", "device"]
    assert set(need) <= set(keys) and keys[-1] == "checks"
    assert ("breakdown" in keys) == trace
    assert set(keys) - set(need) <= {"breakdown", "checks", "requests_per_s"}
    for name, m in line["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"])
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert ("busy_s" in dev) == trace
    for c in line["checks"].values():
        assert set(c) in ({"value", "at_most"}, {"value", "at_least"})
    json.dumps(line)
