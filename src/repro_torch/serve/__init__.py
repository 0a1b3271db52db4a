"""Serving: the ragged multi-stream scheduler."""
from .scheduler import StreamScheduler

__all__ = ["StreamScheduler"]
