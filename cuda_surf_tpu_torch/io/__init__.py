from .image import read_pgm
from .synth import (MAIN_PAIR, TERRAIN_TRACK, TERRAIN_VO, Intrinsics,
                    main_batch, main_pair, render_plane_sequence,
                    render_terrain_sequence)

__all__ = ["read_pgm", "render_plane_sequence", "render_terrain_sequence",
           "Intrinsics", "MAIN_PAIR", "TERRAIN_TRACK", "TERRAIN_VO",
           "main_pair", "main_batch"]
