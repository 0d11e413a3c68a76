from .core import (BAProblem, BAState, project, residuals, cost, run_lm,
                   lm_step, problem_from_numpy, state_from_numpy)

__all__ = [
    "BAProblem", "BAState", "project", "residuals", "cost", "run_lm",
    "lm_step", "problem_from_numpy", "state_from_numpy",
]
