"""Run one cell of `BENCHMARK.json` once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Set-up (imports, CUDA, the kernel library,
the inputs rendered on the card from the seed, warm-up) is timed and
printed part by part; then a closed loop of one client sends each request
when the last has completed, for `--seconds`; then a sample of the
window's requests, drawn from the seed, is worked out again by the plain
reference (`reference/`) and compared.  The last line of standard output
is the JSON result; the last lines of standard error are the numbers
compared, each beside its limit.  With `--trace 1` a block of the mix's
`trace_requests` requests runs under torch.profiler before the window,
and the line carries the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from . import traffic  # noqa: E402
from .reference import precision  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cuda_surf_tpu"}
TAIL = re.compile(r"^(\w+)_ms_p(\d+)$")


class NoDevice(RuntimeError):
    pass


def load_bench(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_spec(bench: dict, name: str):
    cell = next(c for c in bench["workloads"] if c["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return cell, conf


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def per_layer_of(bench: dict, cell: str) -> list:
    """The per-layer metrics that list `cell` under their `workloads`."""
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"),
        HERE / "layer_metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi not readable"


def described_of(out) -> list:
    """The Keypoints of each frame the request described, fields (N,)."""
    res = []
    for kp in out.kps:
        if kp.x.ndim == 1:
            res.append(kp)
        else:
            res += [type(kp)(*[f[b] for f in kp]) for b in range(kp.x.shape[0])]
    return res


class Reservoir:
    """A uniform sample of k of the window's requests, drawn from the seed
    (algorithm R), kept with their outputs."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept, self.seen = k, random.Random(seed), {}, 0

    def offer(self, i: int, out):
        if len(self.kept) < self.k:
            self.kept[i] = out
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                del self.kept[sorted(self.kept)[j]]
                self.kept[i] = out
        self.seen += 1


def end_to_end(bench: dict, workload: str, setup_s: float, frames: int,
               elapsed: float, lat: list) -> dict:
    """The cell's end-to-end metrics from the window's host clock."""
    out = {}
    for m in bench["end_to_end"]:
        if not reports(m, workload):
            continue
        name, tail = m["name"], TAIL.match(m["name"])
        if name == "setup_s":
            v = setup_s
        elif name == "frames_per_s":
            v = frames / elapsed
        elif tail and len(lat) >= 2:
            q = int(tail.group(2))
            v = statistics.quantiles(lat, n=100, method="inclusive")[q - 1]
        else:
            continue
        out[name] = {"value": v, "unit": m["unit"]}
    return out


def check(value, limit) -> tuple:
    """One number against its limit -> (its entry in the result line,
    kept).  A number that was not computed, or is not finite, is None and
    fails: a comparison that never ran proves nothing."""
    if value is not None and not math.isfinite(value):
        value = None
    if isinstance(limit, dict):
        return ({"value": value, "at_least": limit["at_least"]},
                value is not None and value >= limit["at_least"])
    return {"value": value, "at_most": limit}, value is not None and value <= limit


def per_layer(bench: dict, workload: str, ctx) -> dict:
    """The cell's per-layer metrics read from the traced block; a reader
    that finds nothing to read leaves its metric out."""
    out = {}
    for m in per_layer_of(bench, workload):
        v = load_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", root: Path = Path("."), overrides: dict | None = None,
        control: bool = False, log=print) -> dict:
    """One run of a cell -> the result object.  `device="cpu"`, the
    `overrides` of the configuration's `frame` / `surf` / the mix, and
    `control` (the plain reference under TF32 in the program's place)
    serve the tests and the calibration; the command line runs the
    program on the card."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    bench = load_bench(root)
    cell, conf = cell_spec(bench, workload)
    cfg = json.loads((root / conf["file"]).read_text())
    mix = traffic.load_mix(cell["traffic"])
    overrides = overrides or {}
    for part in ("frame", "surf"):
        cfg[part] = dict(cfg[part], **overrides.get(part, {}))
    mix.update(overrides.get("mix", {}))
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < cell["chips"]):
        raise NoDevice(f"{workload} needs {cell['chips']} CUDA device(s)")

    # set-up: every part timed, printed on a line of its own
    setup = {}
    import cuda_surf_tpu_torch as lib
    form = traffic.part("forms", mix["request"])
    if control:
        from .reference import surfref as lib
    setup["import_s"] = time.perf_counter() - T_START
    t = time.perf_counter()
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=device)
        sync(device)
    setup["cuda_init_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if on_card:
        from cuda_surf_tpu_torch import _build
        setup["library_built_s"] = _build.kernels().build_seconds
    setup["library_s"] = time.perf_counter() - t
    t = time.perf_counter()
    inputs = traffic.make_inputs(mix, cfg["frame"], seed, device)
    sync(device)
    setup["render_s"] = time.perf_counter() - t
    if on_card:     # the peak is the serving's, not the renderer's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    prec = precision.tf32 if control else precision.fp32
    with prec():
        call = form.Requests(lib, cfg, inputs, device)

    def serve(i):
        with prec():
            return call(i)

    for i in range(-mix.get("setup_frames", 0), 0):   # the orbit's first
        serve(i)
    for i in range(mix.get("warmup", 0)):   # warms every shape the mix uses
        serve(i)
    sync(device)
    setup["warmup_s"] = time.perf_counter() - t
    setup_s = setup["setup_s"] = time.perf_counter() - T_START
    log("setup " + json.dumps(setup))

    fpr = inputs.frames_per_request()
    i = 0
    if trace:
        from .trace import run_traced
        ctx, breakdown = run_traced(serve, mix["trace_requests"], fpr, cfg,
                                    (cfg["frame"]["h"], cfg["frame"]["w"]),
                                    described_of, lambda: sync(device))
        i = mix["trace_requests"]

    # the window: one client, each request sent when the last completed
    sample = Reservoir(mix["sample"], seed)
    lat, failed, attempted = [], 0, 0
    t0 = t_last = time.perf_counter()
    while time.perf_counter() < t0 + seconds:
        attempted += 1
        ts = time.perf_counter()
        try:
            out = serve(i)
        except Exception as e:                # counted, the loop goes on
            failed += 1
            log(f"request {i} failed: {e!r}", file=sys.stderr)
            i += 1
            continue
        t_last = time.perf_counter()
        lat.append((t_last - ts) * 1e3)
        sample.offer(i, out)
        i += 1
    sync(device)
    elapsed = max(t_last - t0, 1e-9)
    if len(lat) >= 2:
        q = statistics.quantiles(lat, n=100, method="inclusive")
        log("window " + json.dumps({"requests": len(lat), "ms_p10": q[9],
                                    "ms_p50": q[49], "ms_p90": q[89],
                                    "ms_p99": q[98]}))
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    done = attempted - failed
    held = getattr(call, "held", None)
    if hasattr(call, "close"):
        call.close()
    del call
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    from .reference.judge import Judge
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    judge = Judge(cfg, inputs, device, form, limits,
                  log=lambda m: log(m, file=sys.stderr))
    numbers = judge.numbers(sample.kept, held)
    checks, kept = {}, []
    for k, lim in limits.items():
        checks[k], ok = check(numbers.get(k), lim)
        kept.append(ok)
    log("unlimited " + json.dumps({k: v for k, v in numbers.items()
                                   if k not in limits}))
    log(f"check_s {time.perf_counter() - t_check:.3f}")
    correct = failed == 0 and done > 0 and all(kept)

    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    if trace:
        metrics = per_layer(bench, workload, ctx)
        dev.update(busy_s=ctx.union_busy(), window_s=ctx.window_s)
    else:
        metrics = end_to_end(bench, workload, setup_s, done * fpr, elapsed,
                             lat)
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev}
    if trace:
        line["breakdown"] = breakdown
    line["requests_per_s"] = done / elapsed
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the card",
              file=sys.stderr)
        return 3
    try:
        line = run(a.workload, a.seed, a.seconds, bool(a.trace))
    except NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    print("card: " + card_line())
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad}, which the port must not "
              "load", file=sys.stderr)
        return 4
    for k, c in line["checks"].items():
        side, lim = next((s, c[s]) for s in ("at_most", "at_least") if s in c)
        print(f"check {k} = {c['value']!r} ({side.replace('_', ' ')} "
              f"{lim!r})", file=sys.stderr)
    print(f"correct = {line['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
