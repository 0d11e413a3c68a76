from ..io.synth import Intrinsics
from .tracking import default_intrinsics, track_pair, TrackResult
from .pipeline import SlamPipeline, FrameState
from .evaluate import ate_rmse, umeyama_align
from .mapping import Keyframe, KeyframeMap
from .sequence import (render_plane_sequence, render_terrain_sequence,
                       render_forward_sequence, run_sequence, SequenceResult)

__all__ = [
    "Intrinsics", "default_intrinsics", "track_pair", "TrackResult",
    "SlamPipeline", "FrameState", "ate_rmse", "umeyama_align", "Keyframe",
    "KeyframeMap", "render_plane_sequence", "render_terrain_sequence",
    "render_forward_sequence", "run_sequence", "SequenceResult",
]
