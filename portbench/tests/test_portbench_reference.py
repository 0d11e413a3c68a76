"""The benchmark's renderers and its plain reference against the
program's own plain path, at tiny sizes on the CPU."""

import numpy as np
import torch

from portbench.scenes import render as scenes
from portbench.reference import surfref
from portbench.reference.precision import round_tf32


def _grids(seed, cells):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 1, (1, scenes.T // c + 2,
                                               scenes.T // c + 2)))
            for c in cells]


def test_renderers_match_io_synth():
    from cuda_surf_tpu_torch.io import synth
    tex = scenes.multiscale_texture(_grids(3, scenes.PLANE_CELLS),
                                    scenes.PLANE_CELLS) * 255.0
    got = scenes.render_plane(tex, 48, 64, 2, 0.02)[0].numpy()
    want = synth.render_plane_sequence(n_frames=2, h=48, w=64, seed=3,
                                       motion=0.02,
                                       cells=scenes.PLANE_CELLS)[0]
    assert np.array_equal(got, want)
    tex, elev = scenes.terrain_maps(_grids(5, scenes.TERRAIN_CELLS),
                                    _grids(6, scenes.ELEV_CELLS))
    got = scenes.render_terrain(tex, elev, 24, 32,
                                scenes.orbit_poses(60)[:3]).numpy()
    want = synth.render_terrain_sequence(60, 24, 32, seed=5, first=3)[0]
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_reference_agrees_with_the_port_plain_path():
    import cuda_surf_tpu_torch as port
    from cuda_surf_tpu_torch.io import synth
    kw = dict(noctaves=3, thresh=2.0, max_pts=256, candidates_per_octave=256)
    frames = synth.render_terrain_sequence(60, 72, 96, seed=2, first=2)[0]
    ref = surfref.Surf(surfref.SurfConfig(**kw), device="cpu")
    prog = port.Surf(port.SurfConfig(**kw), device="cpu")
    outs = []
    for s in (ref, prog):
        (k1, d1), (k2, d2) = (s.detect_and_compute(f) for f in frames)
        outs.append((k1, d1, s.match(k1, d1, k2, d2)))
    (kr, dr, mr), (kp, dp, mp) = outs
    assert int(kr.count) == int(kp.count) > 10
    for f in ("x", "y", "scale", "laplace", "valid"):
        assert torch.equal(getattr(kr, f), getattr(kp, f))
    assert torch.equal(dr, dp)
    assert torch.equal(mr.index, mp.index) and torch.equal(mr.score, mp.score)


def test_tf32_rounding():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -3.0000001, 0.0])
    assert round_tf32(x).tolist() == [1.0, 1 + 2 ** -9, -3.0, 0.0]
