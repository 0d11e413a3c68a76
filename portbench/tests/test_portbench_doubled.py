"""The doubled cell, `surf_dbl.batch32`, through whole runs at a tiny size
on the CPU (the program runs its plain twins): a sound run is correct, the
control (the plain reference at TF32 in the program's place) is not, and
a traced run's five per-layer readers each return a number."""

from portbench import run
from portbench.tests.helpers import ROOT, TINY_SURF

CELL = "surf_dbl.batch32"
# one sampled request, so that a window that a loaded host lets complete
# only its first request is still compared
TINY = dict(TINY_SURF, mix=dict(TINY_SURF["mix"], frames=3, sample=1))
QUIET = dict(log=lambda *a, **k: None)
READERS = ("integral_roofline.dbl", "detect_roofline.dbl",
           "describe_roofline.dbl", "device_ops_per_frame.dbl",
           "device_idle_pct.dbl")


def _run(trace=False, **kw):
    return run.run(CELL, 2**31 + 22, kw.pop("seconds", 2.0), trace,
                   device="cpu", root=ROOT, overrides=TINY, **kw)


def test_sound_run_is_correct():
    line = _run(**QUIET)
    assert line["correct"], line["checks"]
    assert line["checks"]["uncompared"]["value"] == 0


def test_control_is_not_correct():
    line = _run(control=True, **QUIET)
    assert not line["correct"], line["checks"]


def test_the_readers_read_a_traced_run(monkeypatch):
    """On the CPU the profiler sees no kernel of the card, so the kernel
    names of a card's trace are planted in the traced block: G's doubled
    passes, A and B, each 1 ms a frame."""
    from portbench import trace
    real = trace.run_traced

    def planted(*a, **k):
        ctx, breakdown = real(*a, **k)
        t = 0.0
        for name in ("integral_doubled_write<true>", "pyramid_kernel",
                     "describe_kernel<true, 4>"):
            ctx.device_ops.append((name, t, t + 1e-3 * ctx.frames))
            t += 1e-3 * ctx.frames
        ctx.device_ops.sort(key=lambda r: r[1])
        return ctx, breakdown

    monkeypatch.setattr(trace, "run_traced", planted)
    line = _run(trace=True, seconds=0.5, **QUIET)
    got = line["metrics"]
    assert set(READERS) <= set(got), got
    for name in READERS:
        assert got[name]["value"] > 0, name
    for name in READERS[:3]:
        assert got[name]["value"] < 100, name
