from ..io.synth import Intrinsics
from .tracking import default_intrinsics, track_pair, TrackResult
from .pipeline import SlamPipeline, FrameState
from .evaluate import ate_rmse, umeyama_align
from .mapping import Keyframe, KeyframeMap
from .posegraph import PoseGraph, optimize as optimize_pose_graph
from .sim3graph import Sim3Graph, optimize_with_loops_sim3
from .loopclosure import LoopClosure, LoopDetector, optimize_with_loops
from .checkpoint import save_pipeline, load_pipeline
from .sequence import (render_plane_sequence, render_terrain_sequence,
                       render_forward_sequence, run_sequence, SequenceResult,
                       load_image_dir, load_tum_trajectory, load_kitti_poses,
                       load_kitti_calib, load_kitti_times,
                       associate_timestamps)

__all__ = [
    "Intrinsics", "default_intrinsics", "track_pair", "TrackResult",
    "SlamPipeline", "FrameState", "ate_rmse", "umeyama_align", "Keyframe",
    "KeyframeMap", "PoseGraph", "optimize_pose_graph", "Sim3Graph",
    "optimize_with_loops_sim3", "LoopClosure", "LoopDetector",
    "optimize_with_loops", "save_pipeline", "load_pipeline",
    "render_plane_sequence", "render_terrain_sequence",
    "render_forward_sequence", "run_sequence", "SequenceResult",
    "load_image_dir", "load_tum_trajectory", "load_kitti_poses",
    "load_kitti_calib", "load_kitti_times", "associate_timestamps",
]
