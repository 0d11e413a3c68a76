from .core import BAProblem, BAState, run_lm

__all__ = ["BAProblem", "BAState", "run_lm"]
