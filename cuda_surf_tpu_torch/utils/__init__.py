from .metrics import MetricsLogger
from .timing import Timer, benchmark, trace

__all__ = ["MetricsLogger", "Timer", "benchmark", "trace"]
