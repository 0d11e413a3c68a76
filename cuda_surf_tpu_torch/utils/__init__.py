from .metrics import MetricsLogger

__all__ = ["MetricsLogger"]
