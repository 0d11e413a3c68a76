from .batch import BatchSurf

__all__ = ["BatchSurf"]
