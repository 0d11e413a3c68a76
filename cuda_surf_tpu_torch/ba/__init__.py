from .core import (BAProblem, BAState, project, residuals, cost, run_lm,
                   lm_step, problem_from_numpy, state_from_numpy)
from .distributed import make_distributed_lm, shard_problem

__all__ = [
    "BAProblem", "BAState", "project", "residuals", "cost", "run_lm",
    "lm_step", "problem_from_numpy", "state_from_numpy",
    "make_distributed_lm", "shard_problem",
]
