from .metrics import MetricsLogger
from .timing import SPANS, Timer, benchmark, span

__all__ = ["MetricsLogger", "SPANS", "Timer", "benchmark", "span"]
