from .image import read_pgm
from .synth import MAIN_PAIR, main_batch, main_pair, render_plane_sequence

__all__ = ["read_pgm", "render_plane_sequence", "MAIN_PAIR", "main_pair",
           "main_batch"]
