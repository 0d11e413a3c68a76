from .mesh import (FRAME_AXIS, Mesh, make_mesh, frame_sharding, replicated,
                   shard_rows)
from .batch import BatchSurf
from .multihost import (initialize_from_env, multiprocess_env, process_count,
                        process_index, global_mesh, global_batch,
                        all_processes_value)
from .elastic import CheckpointDir, Heartbeat, run_elastic

__all__ = ["FRAME_AXIS", "Mesh", "make_mesh", "frame_sharding", "replicated",
           "shard_rows", "BatchSurf", "initialize_from_env",
           "multiprocess_env", "process_count", "process_index",
           "global_mesh", "global_batch", "all_processes_value",
           "CheckpointDir", "Heartbeat", "run_elastic"]
