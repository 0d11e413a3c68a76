from .image import (imread_gray, read_pgm, read_png_gray, write_pgm,
                    write_png, write_ppm)
from .synth import (MAIN_PAIR, TERRAIN_TRACK, TERRAIN_VO, Intrinsics,
                    main_batch, main_pair, render_plane_sequence,
                    render_terrain_sequence)

__all__ = ["imread_gray", "read_pgm", "read_png_gray", "write_pgm",
           "write_png", "write_ppm", "render_plane_sequence",
           "render_terrain_sequence", "Intrinsics", "MAIN_PAIR",
           "TERRAIN_TRACK", "TERRAIN_VO", "main_pair", "main_batch"]
