"""Checkpoint / resume for long SLAM runs (port of
cuda_surf_tpu/slam/checkpoint.py, format version 3).

A plain .npz archive: arrays plus a small JSON header, every key the JAX
package writes, so the port loads a checkpoint the JAX package wrote.  The
trajectory, the per-frame depths, the previous frame's features, the loop
closures, the keyframe map and the loop detector's store (with its evicted
frames) are restored equal, and a restored pipeline continues bit for bit
like one that never stopped, in every mode (plain VO, window_ba,
loop_detect).

The random streams cannot be carried across the packages: the JAX
pipeline splits a JAX key, the port draws from a torch.Generator.  So the
port writes its own under new keys: `torch_rng_state` (the generator's
state, with its device type `torch_rng_device` in the header) and
`det_seed` (the loop detector's seed, in the header).  `rng_key` and
`det_key` hold the JAX form of the pipeline's and the detector's seeds
([seed >> 32, seed & 0xffffffff], as PRNGKey gives it); the detector's key
is exactly the JAX package's, which never advances it.  Loading a JAX
checkpoint keeps the pipeline's own generator and takes the detector's
seed from `det_key`.  Loading the port's files with the JAX package is not
supported: its key would restart the JAX stream at the seed.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..io.synth import Intrinsics
from ..types import Keypoints, keypoints_from_numpy, keypoints_to_numpy
from .loopclosure import LoopClosure, LoopDetector
from .mapping import Keyframe, KeyframeMap
from .pipeline import FrameState, SlamPipeline

_FORMAT_VERSION = 3
# the JAX Keypoints pytree flattens in its field order, the port's fields
_KP_FIELDS = Keypoints._fields


def _seed_key(seed: int) -> np.ndarray:
    return np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _key_seed(key) -> int:
    k = np.asarray(key, np.uint64).reshape(-1)
    return int(k[0]) << 32 | int(k[1])


def _put_keypoints(arrays: dict, prefix: str, kps) -> None:
    fields = kps if isinstance(kps, dict) else keypoints_to_numpy(kps)
    for i, name in enumerate(_KP_FIELDS):
        arrays[f"{prefix}{i}"] = np.asarray(fields[name])


def _get_keypoints(data, prefix: str) -> dict:
    return {name: np.asarray(data[f"{prefix}{i}"])
            for i, name in enumerate(_KP_FIELDS)}


def save_pipeline(path: str, pipe: SlamPipeline) -> None:
    """Write the pipeline's resumable state to `path` (.npz)."""
    arrays = {}
    header = {
        "version": _FORMAT_VERSION,
        "n_frames": len(pipe.frames),
        "has_prev": pipe._prev is not None,
        "prev_depth": pipe._prev_depth,
        "intrinsics": list(pipe.intr) if pipe.intr is not None else None,
        "n_loops": len(pipe.loops),
        "has_map": pipe.map is not None,
        "has_detector": pipe._detector is not None,
        "torch_rng_device": pipe.generator.device.type,
    }
    if pipe.frames:
        arrays["frame_R"] = np.stack([f.R for f in pipe.frames])
        arrays["frame_t"] = np.stack([f.t for f in pipe.frames])
        arrays["frame_meta"] = np.asarray(
            [[f.index, f.n_inliers, int(f.is_keyframe)] for f in pipe.frames],
            np.int64)
    arrays["rng_key"] = _seed_key(pipe.seed)
    arrays["torch_rng_state"] = pipe.generator.get_state().numpy()
    arrays["frame_depths"] = np.asarray(pipe.frame_depths, np.float64)
    if pipe._prev_kp_depth is not None:
        arrays["prev_kp_depth"] = np.asarray(pipe._prev_kp_depth, np.float64)
    if pipe._prev is not None:
        kps, desc = pipe._prev
        _put_keypoints(arrays, "prev_kp_", kps)
        arrays["prev_desc"] = desc.cpu().numpy()
    if pipe.loops:
        arrays["loop_ij_n"] = np.asarray(
            [[lc.i, lc.j, lc.n_inliers] for lc in pipe.loops], np.int64)
        arrays["loop_R"] = np.stack([lc.R for lc in pipe.loops])
        arrays["loop_t"] = np.stack([lc.t for lc in pipe.loops])
        arrays["loop_depth"] = np.asarray(
            [lc.med_depth for lc in pipe.loops], np.float64)
        arrays["loop_depth_j"] = np.asarray(
            [lc.med_depth_j for lc in pipe.loops], np.float64)
    if pipe.map is not None:
        m = pipe.map
        header["map_next_track"] = m._next_track
        header["map_n_keyframes"] = len(m.keyframes)
        if m.keyframes:
            arrays["map_R"] = np.stack([kf.R for kf in m.keyframes])
            arrays["map_t"] = np.stack([kf.t for kf in m.keyframes])
            arrays["map_xy"] = np.stack([kf.xy for kf in m.keyframes])
            arrays["map_valid"] = np.stack([kf.valid for kf in m.keyframes])
            arrays["map_tid"] = np.stack([kf.track_id for kf in m.keyframes])
            arrays["map_index"] = np.asarray(
                [kf.index for kf in m.keyframes], np.int64)
    if pipe._detector is not None:
        det = pipe._detector
        header["det_n_frames"] = len(det._frames)
        header["det_max_store"] = det.max_store
        header["det_seed"] = det.seed
        arrays["det_key"] = _seed_key(det.seed)
        if det._sigs:
            # signatures of every frame; full features only of the frames
            # still in the (possibly ring-capped) store
            arrays["det_sigs"] = np.stack(det._sigs)
        retained = [f for f, v in enumerate(det._frames) if v is not None]
        header["det_retained"] = retained
        for f in retained:
            kps, desc = det._frames[f]
            _put_keypoints(arrays, f"det_kp_{f}_", kps)
            arrays[f"det_desc_{f}"] = np.asarray(desc)
        header["det_n_leaves"] = len(_KP_FIELDS) if retained else 0
    arrays["header"] = np.frombuffer(json.dumps(header).encode(),
                                     dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_pipeline(path: str, pipe: SlamPipeline) -> SlamPipeline:
    """Restore state saved by :func:`save_pipeline`, or by the JAX
    package's, into `pipe` (constructed with the same config)."""
    data = np.load(path)
    header = json.loads(bytes(data["header"]).decode())
    if header["version"] > _FORMAT_VERSION:
        raise ValueError(f"checkpoint version {header['version']} "
                         f"> {_FORMAT_VERSION}")
    # version 2 introduced the window_ba / loop_detect state; later
    # versions only add optional fields with load-time fallbacks
    if header["version"] < 2 and (pipe.window_ba or pipe.loop_detect):
        raise ValueError(
            "version-1 checkpoint cannot restore window_ba/loop_detect "
            "state; re-save with the current format or resume a plain-VO "
            "pipeline")
    pipe.reset()
    if header["intrinsics"] is not None:
        pipe.intr = Intrinsics(*header["intrinsics"])
    if header["n_frames"]:
        meta = data["frame_meta"]
        for k in range(header["n_frames"]):
            pipe.frames.append(FrameState(
                index=int(meta[k, 0]), R=data["frame_R"][k],
                t=data["frame_t"][k], n_inliers=int(meta[k, 1]),
                is_keyframe=bool(meta[k, 2])))
    if "torch_rng_state" in data:
        if header["torch_rng_device"] != pipe.generator.device.type:
            raise ValueError(
                f"checkpoint draws from a {header['torch_rng_device']} "
                f"generator, the pipeline from a "
                f"{pipe.generator.device.type} one")
        pipe.generator.set_state(torch.as_tensor(data["torch_rng_state"]))
    pipe._prev_depth = header["prev_depth"]
    if "frame_depths" in data:
        pipe.frame_depths = [float(d) for d in data["frame_depths"]]
    if "prev_kp_depth" in data:
        pipe._prev_kp_depth = data["prev_kp_depth"]
    if header["has_prev"]:
        pipe._prev = (
            keypoints_from_numpy(_get_keypoints(data, "prev_kp_"),
                                 pipe.device),
            torch.as_tensor(data["prev_desc"], device=pipe.device))
    for k in range(header.get("n_loops", 0)):
        ijn = data["loop_ij_n"][k]
        dj = (float(data["loop_depth_j"][k]) if "loop_depth_j" in data
              else 0.0)  # older checkpoints: sim3 falls back to med_i
        pipe.loops.append(LoopClosure(
            i=int(ijn[0]), j=int(ijn[1]), R=data["loop_R"][k],
            t=data["loop_t"][k], n_inliers=int(ijn[2]),
            med_depth=float(data["loop_depth"][k]), med_depth_j=dj))
    if header.get("has_map"):
        pipe.map = KeyframeMap(pipe.intr, window=pipe.window_ba or 5,
                               device=pipe.device)
        pipe.map._next_track = header["map_next_track"]
        for k in range(header.get("map_n_keyframes", 0)):
            pipe.map.keyframes.append(Keyframe(
                index=int(data["map_index"][k]), R=data["map_R"][k],
                t=data["map_t"][k], xy=data["map_xy"][k],
                valid=data["map_valid"][k],
                track_id=data["map_tid"][k].copy()))
    if header.get("has_detector"):
        seed = header.get("det_seed", _key_seed(data["det_key"]))
        det = LoopDetector(pipe.intr, min_gap=pipe.loop_min_gap,
                           max_store=header.get("det_max_store"), seed=seed,
                           device=pipe.device)
        pipe._detector = det
        n_frames = header.get("det_n_frames", 0)
        retained = header.get("det_retained")  # absent in version <= 2
        retained = set(range(n_frames) if retained is None else retained)
        for f in range(n_frames):
            if f in retained:
                entry = (_get_keypoints(data, f"det_kp_{f}_"),
                         np.asarray(data[f"det_desc_{f}"]))
                det._frames.append(entry)
                det._sigs.append(det._signature(*entry))
            else:
                det._frames.append(None)
                det._sigs.append(None)
        if "det_sigs" in data:  # authoritative (covers evicted frames)
            det._sigs = [np.asarray(s) for s in data["det_sigs"]]
    return pipe
