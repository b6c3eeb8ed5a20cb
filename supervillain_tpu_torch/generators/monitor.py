"""Monitoring wrapper: PyTorch counterpart of
:class:`supervillain_tpu.generators.monitor.Logger`."""

from __future__ import annotations

import logging

import torch

from ..tracing import span
from ..utils import Timer
from .base import Generator

logger = logging.getLogger(__name__)


class Logger(Generator):
    """Wrap a generator: time each step and send the elapsed time and the
    step's inline observables to ``channel``.  Each step runs in a
    ``Logger.step`` span (:mod:`..tracing`).  With ``timer``, the host clock
    is read after waiting for the card that holds the fields, before the
    step and after it, so the time is the step's work, not its enqueue."""

    def __init__(self, generator, channel=logger.info, timer=True):
        self.generator = generator
        self.channel = channel
        self.timer = timer
        self.name = generator.name

    def __str__(self):
        return f'Logger({self.generator})'

    def init_stats(self):
        return self.generator.init_stats()

    def inline_shapes(self):
        return self.generator.inline_shapes()

    def prepare(self, cfg):
        return self.generator.prepare(cfg)

    def step(self, generator, cfg, stats):
        with span('Logger.step'):
            if self.timer:
                _synchronize(cfg)
            with Timer(self.channel if self.timer else None, f'{self.generator} step'):
                cfg, stats, inline = self.generator.step(generator, cfg, stats)
                if self.timer:
                    _synchronize(cfg)
            if self.channel is not None:
                self.channel(inline)
        return cfg, stats, inline

    def report(self, stats):
        return self.generator.report(stats)


def _synchronize(cfg):
    """Wait for the work queued on the cards that hold the fields ``cfg``: a
    dict of tensors, or a list of them (a row's slabs on a space mesh)."""
    parts = cfg if isinstance(cfg, list) else [cfg]
    for device in {v.device for p in parts for v in p.values()
                   if isinstance(v, torch.Tensor) and v.is_cuda}:
        torch.cuda.synchronize(device)
