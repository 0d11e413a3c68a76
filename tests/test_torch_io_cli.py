"""The port's sequence driver, loaders, image codecs, drawing and the two
demo CLIs on the CPU, against the JAX package on files written under
`tmp_path`, each test with its own `default_rng`.

Equal means equal: the loaders, codecs and drawing are numpy copies of
the JAX package's, so their outputs (and the bytes the writers write) are
held to JAX's exactly; `run_sequence` over image paths with a crash and a
resume through `checkpoint_dir` gives the continuous run's trajectory bit
for bit; the CLIs run to their end at a small size with `--device cpu`.
"""

import glob
import os

import numpy as np
import pytest

from cuda_surf_tpu import viz as jviz
from cuda_surf_tpu.io import image as jimage
from cuda_surf_tpu.slam import sequence as jseq

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch import demo, viz
from cuda_surf_tpu_torch.config import VO_CONFIG
from cuda_surf_tpu_torch.io import image, native, synth
from cuda_surf_tpu_torch.parallel.elastic import Heartbeat
from cuda_surf_tpu_torch.slam import SlamPipeline, run_sequence, sequence
from cuda_surf_tpu_torch.slam import demo as slam_demo
from cuda_surf_tpu_torch.utils import Timer, benchmark, span
from torch_parity import one_torch_thread  # noqa: F401


def _pipe(intr):
    return SlamPipeline(cst.SurfConfig(**VO_CONFIG), intrinsics=intr,
                        device="cpu")


def test_run_sequence_paths_checkpoint_heartbeat(tmp_path):
    """tests/test_slam_sequence.py::test_run_sequence_checkpoint_resume on
    the port, over PGM paths streamed through the loader: a run "crashed"
    after 4 frames, then the same call over the whole list resumes from
    the newest checkpoint and equals the continuous run on arrays."""
    frames, centres, intr = synth.render_plane_sequence(n_frames=6, h=200,
                                                        w=280, seed=3)
    paths = []
    for k, f in enumerate(frames):
        paths.append(str(tmp_path / f"f{k:03d}.pgm"))
        image.write_pgm(paths[-1], f)
    assert sequence.load_image_dir(str(tmp_path)) == paths
    with native.FrameLoader(paths, depth=2) as fl:
        assert fl.path == ("native" if native.available() else "python")
        for a, b in zip(fl, frames):
            np.testing.assert_array_equal(a, b)
    full = run_sequence(_pipe(intr), frames, gt=centres)
    d = str(tmp_path / "ckpts")
    run_sequence(_pipe(intr), paths[:4], checkpoint_dir=d,
                 checkpoint_every=2)
    assert glob.glob(d + "/pipeline_*.npz")
    hb = str(tmp_path / "hb.json")
    pipe = _pipe(intr)
    res = run_sequence(pipe, paths, gt=centres, checkpoint_dir=d,
                       checkpoint_every=2, heartbeat_path=hb)
    assert len(pipe.frames) == len(frames)
    np.testing.assert_array_equal(res.trajectory, full.trajectory)
    assert res.ate == full.ate and res.ate < 0.08
    payload = Heartbeat.read(hb, dead_after=60.0)
    assert payload["step"] == len(frames) - 1 and not payload["dead"]
    assert len(glob.glob(d + "/pipeline_*.npz")) <= 3
    assert not glob.glob(d + "/.tmp_*")


def test_loaders_equal_jax(tmp_path):
    rng = np.random.default_rng(21)
    n = 7
    ts = np.sort(rng.uniform(0, 10, n))
    rows = np.concatenate([ts[:, None], rng.normal(size=(n, 7))], 1)
    tum = tmp_path / "gt.txt"
    tum.write_text("# timestamp tx ty tz qx qy qz qw\n" + "\n".join(
        " ".join(repr(float(v)) for v in r) for r in rows) + "\n\n")
    poses = tmp_path / "00.txt"
    poses.write_text("\n".join(" ".join(repr(float(v)) for v in r)
                               for r in rng.normal(size=(5, 12))) + "\n")
    calib = tmp_path / "calib.txt"
    calib.write_text(
        "P0: 718.856 0 607.1928 0 0 718.856 185.2157 0 0 0 1 0\n"
        "P1: 718.856 0 607.1928 -386.1448 0 718.856 185.2157 0 0 0 1 0\n")
    times = tmp_path / "times.txt"
    times.write_text("0.0\n0.103\n0.207\n")
    for a, b in zip(sequence.load_tum_trajectory(str(tum)),
                    jseq.load_tum_trajectory(str(tum))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(sequence.load_kitti_poses(str(poses)),
                    jseq.load_kitti_poses(str(poses))):
        np.testing.assert_array_equal(a, b)
    for cam in (0, 1):
        assert tuple(sequence.load_kitti_calib(str(calib), cam)) == \
            tuple(jseq.load_kitti_calib(str(calib), cam))
    np.testing.assert_array_equal(sequence.load_kitti_times(str(times)),
                                  jseq.load_kitti_times(str(times)))
    tb = np.sort(ts + rng.normal(0, 0.01, n))
    np.testing.assert_array_equal(sequence.associate_timestamps(ts, tb),
                                  jseq.associate_timestamps(ts, tb))
    with pytest.raises(ValueError, match="no P3"):
        sequence.load_kitti_calib(str(calib), 3)
    with pytest.raises(FileNotFoundError):
        sequence.load_image_dir(str(tmp_path / "none"))


def test_image_codecs_equal_jax(tmp_path):
    rng = np.random.default_rng(22)
    gray = rng.integers(0, 256, (40, 56), np.uint8)
    rgb = rng.integers(0, 256, (16, 24, 3), np.uint8)
    for name, write, img in (("pgm", "write_pgm", gray),
                             ("ppm", "write_ppm", rgb),
                             ("png", "write_png", gray),
                             ("rgb.png", "write_png", rgb)):
        a, b = str(tmp_path / f"t.{name}"), str(tmp_path / f"j.{name}")
        getattr(image, write)(a, img)
        getattr(jimage, write)(b, img)
        assert open(a, "rb").read() == open(b, "rb").read(), name
        if name != "ppm":
            np.testing.assert_array_equal(image.imread_gray(a),
                                          jimage.imread_gray(b))
    np.testing.assert_array_equal(
        image.read_png_gray(str(tmp_path / "t.png")), gray)
    np.testing.assert_array_equal(native.read_gray(str(tmp_path / "t.pgm")),
                                  gray)
    np.testing.assert_array_equal(native.read_gray(str(tmp_path / "t.png")),
                                  gray)
    with pytest.raises(ValueError, match="unsupported"):
        (tmp_path / "x.bmp").write_bytes(b"BM" + bytes(10))
        image.imread_gray(str(tmp_path / "x.bmp"))


def test_viz_equal_jax(tmp_path):
    rng = np.random.default_rng(23)
    img = rng.integers(0, 256, (60, 80), np.uint8)
    n = 30
    kps = cst.Keypoints(
        *[np.asarray(a) for a in (
            rng.uniform(0, 80, n).astype(np.float32),
            rng.uniform(0, 60, n).astype(np.float32),
            np.full(n, 2.0, np.float32),
            rng.uniform(0, 8, n).astype(np.float32), np.ones(n, np.int32),
            np.zeros(n, np.float32), np.zeros(n, np.int32),
            rng.uniform(size=n) < 0.7, np.int32(n))])
    m = cst.Matches(score=rng.uniform(0.5, 1, n).astype(np.float32),
                    index=np.arange(n, dtype=np.int32),
                    match_x=rng.uniform(0, 80, n).astype(np.float32),
                    match_y=rng.uniform(0, 60, n).astype(np.float32),
                    ambiguity=rng.uniform(0, 1, n).astype(np.float32),
                    valid=rng.uniform(size=n) < 0.8)
    np.testing.assert_array_equal(viz.draw_keypoints(img, kps),
                                  jviz.draw_keypoints(img, kps))
    for kw in (dict(), dict(horizontal=False, max_lines=5, min_score=0.7)):
        np.testing.assert_array_equal(
            viz.draw_matches(img, kps, img, kps, m, **kw),
            jviz.draw_matches(img, kps, img, kps, m, **kw))
    th = np.linspace(0, 2 * np.pi, 40)
    gt = np.stack([np.cos(th), np.sin(th), 0 * th], -1)
    trajs = {"gt": gt, "vo": gt + 0.03}
    a, b = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    image.write_png(a, viz.plot_trajectories(trajs))
    jimage.write_png(b, jviz.plot_trajectories(trajs))
    assert open(a, "rb").read() == open(b, "rb").read()
    # the port's tensors go through viz.host
    import torch
    kt = cst.Keypoints(*[torch.as_tensor(a) for a in kps])
    np.testing.assert_array_equal(viz.draw_keypoints(img, viz.host(kt)),
                                  jviz.draw_keypoints(img, kps))


def test_demo_cli_cpu(tmp_path, capsys):
    frames, _, _ = synth.render_plane_sequence(n_frames=2, h=120, w=160,
                                               seed=1)
    paths = [str(tmp_path / n) for n in ("a.pgm", "b.pgm")]
    for p, f in zip(paths, frames):
        image.write_pgm(p, f)
    demo.main(paths + ["--iters", "2", "--octaves", "2", "--max-pts", "256",
                       "--out-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "detect+describe (pair)" in out and "matches:" in out
    for name in ("surf_show1.ppm", "surf_show2.ppm", "surf_show_matched.ppm"):
        assert os.path.getsize(str(tmp_path / name)) > 160 * 120
    demo.main(paths[:1] + ["--single", "--iters", "2", "--octaves", "2",
                           "--max-pts", "256", "--device", "cpu"])
    assert "ms/frame over 2 iterations" in capsys.readouterr().out
    with Timer() as t:
        with span("surf.detect"):
            benchmark(lambda: np.ones(4).sum(), iters=3, device="cpu")
    assert t.elapsed_ms > 0


def test_slam_demo_cli_cpu(tmp_path, capsys):
    ck, metrics = str(tmp_path / "state.npz"), str(tmp_path / "m.jsonl")
    slam_demo.main(["--synthetic-frames", "4", "--max-pts", "512",
                    "--posegraph", "--checkpoint", ck, "--metrics", metrics,
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ATE after pose graph" in out and "frames: 4" in out
    assert os.path.exists(ck) and len(open(metrics).readlines()) == 4
