"""Wall-clock context-manager timer: a copy of :mod:`supervillain_tpu.utils.timer`."""

from __future__ import annotations

import time


class Timer:
    """Context manager that logs elapsed wall-clock time, optionally per item.

    Parameters
    ----------
    channel: callable
        Where to send the message (e.g. ``logger.info``); ``None`` silences it.
    message: str
        What was being timed.
    per: int, optional
        If given, also log the per-item cost.
    """

    def __init__(self, channel, message='', per=None):
        self.channel = channel
        self.message = message
        self.per = per
        self.start = None
        self.elapsed = None

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        if self.channel is not None:
            msg = f'{self.message} [{self.elapsed:.6f} seconds]'
            if self.per:
                msg += f' ({self.elapsed / self.per:.3e} each)'
            self.channel(msg)
        return False
