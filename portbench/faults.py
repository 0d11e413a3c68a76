"""Faults planted in the program's timed path, for the readings that the
correctness check's limits are set from (`calibrate.py`) and for the tests
that see a run with each of them come out not correct.  Each is a context
manager that patches the program where the fault would be made and puts
it back after.

- `descriptor_altered`: the first entry of the first descriptor that
  each call makes moved by 1e-3, where the descriptors are made;
- `keypoint_moved`: the first keypoint of every detection moved by 0.01
  px in x where the keypoints are made;
- `laplace_flipped`: the first keypoint's Laplacian sign flipped there;
- `match_altered`: the first valid match of every matched pair sent to
  another keypoint where the matches are made;
- `half_batch`: the second half of every batch left out (its keypoints
  and descriptors zero);
- `pose_frozen`: a VO step that returns the pose of the frame before;
- `track_hidden`: the pipeline reaches its pair tracking through another
  name, so the outputs the check reads never arrive.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def descriptor_altered():
    import cuda_surf_tpu_torch.frontend as fe

    def make(describe):
        def altered(*a, **k):
            d = describe(*a, **k).clone()
            d[0, 0] += 1e-3
            return d
        return altered

    with _patched(fe, "describe", make):
        yield


def _keypoints_altered(field: int, alter):
    """Field `field` of what `frontend._make_keypoints` returns (count,
    valid, x, y, scale, strength, laplace, octave, ...) altered at the
    first slot by `alter`."""
    import cuda_surf_tpu_torch.frontend as fe

    def make(make_keypoints):
        def altered(*a, **k):
            out = list(make_keypoints(*a, **k))
            f = out[field].clone()
            f[0] = alter(f[0])
            out[field] = f
            return tuple(out)
        return altered

    return _patched(fe, "_make_keypoints", make)


def keypoint_moved():
    return _keypoints_altered(2, lambda x: x + 0.01)


def laplace_flipped():
    return _keypoints_altered(6, lambda s: -s)


def _alter_first(m):
    """The first valid match (of each pair) sent to the next keypoint."""
    valid = m.valid.reshape(-1, m.valid.shape[-1])
    index = m.index.reshape(valid.shape).clone()
    n2 = int(index.max()) + 2
    first = valid.int().argmax(1)
    rows = torch.arange(index.shape[0], device=index.device)
    index[rows, first] = (index[rows, first] + 1) % n2
    return m._replace(index=index.reshape(m.index.shape))


@contextlib.contextmanager
def match_altered():
    import cuda_surf_tpu_torch.frontend as fe
    import cuda_surf_tpu_torch.slam.tracking as tr

    make = lambda match: lambda *a, **k: _alter_first(match(*a, **k))
    with _patched(fe, "match_keypoints", make), \
            _patched(tr, "match_keypoints", make):
        yield


@contextlib.contextmanager
def half_batch():
    import cuda_surf_tpu_torch.frontend as fe

    def make(batch):
        def half(images, *a, **k):
            kp, d = batch(images, *a, **k)
            B = images.shape[0]
            keep = torch.arange(B, device=images.device) < (B + 1) // 2
            kp = type(kp)(*[f * keep.view(-1, *[1] * (f.ndim - 1)).to(f.dtype)
                            for f in kp])
            return kp, d * keep.view(-1, 1, 1)
        return half

    with _patched(fe, "detect_and_compute_batch", make):
        yield


@contextlib.contextmanager
def pose_frozen():
    import cuda_surf_tpu_torch.slam.pipeline as pl

    def make(process):
        def frozen(self, image, *a, **k):
            before = self.frames[-1] if self.frames else None
            st = process(self, image, *a, **k)
            if before is not None:
                st = type(st)(st.index, before.R, before.t, st.n_inliers,
                              st.is_keyframe)
                self.frames[-1] = st
            return st
        return frozen

    with _patched(pl.SlamPipeline, "process", make):
        yield


@contextlib.contextmanager
def track_hidden():
    import cuda_surf_tpu_torch.slam.pipeline as pl
    from cuda_surf_tpu_torch.slam import tracking

    def make(process):
        def hidden(self, image, *a, **k):
            seen = pl.track_pair
            pl.track_pair = tracking.track_pair
            try:
                return process(self, image, *a, **k)
            finally:
                pl.track_pair = seen
        return hidden

    with _patched(pl.SlamPipeline, "process", make):
        yield


FAULTS = {       # name -> (planter, the request forms that can have it)
    "descriptor_altered": (descriptor_altered, ("pair", "batch", "frame")),
    "keypoint_moved": (keypoint_moved, ("pair", "batch", "frame")),
    "laplace_flipped": (laplace_flipped, ("pair", "batch", "frame")),
    "match_altered": (match_altered, ("pair", "batch", "frame")),
    "half_batch": (half_batch, ("batch",)),
    "pose_frozen": (pose_frozen, ("frame",)),
    "track_hidden": (track_hidden, ("frame",)),
}


def of_form(form: str) -> list:
    """The faults that a cell of request form `form` can have."""
    return [n for n, (_, forms) in FAULTS.items() if form in forms]
