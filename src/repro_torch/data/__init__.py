"""Data pipeline: sharded synthetic corpus + MutableLock'd prefetch."""

from .pipeline import DataConfig, PrefetchLoader, SyntheticCorpus

__all__ = ["DataConfig", "SyntheticCorpus", "PrefetchLoader"]
