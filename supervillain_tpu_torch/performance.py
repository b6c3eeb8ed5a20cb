"""Reference-compatible namespace: re-exports the wall-clock :class:`Timer`
(counterpart of :mod:`supervillain_tpu.performance`)."""

from .utils.timer import Timer

__all__ = ['Timer']
