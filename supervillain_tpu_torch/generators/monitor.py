"""Monitoring wrapper: PyTorch counterpart of
:class:`supervillain_tpu.generators.monitor.Logger`."""

from __future__ import annotations

import logging

from ..utils import Timer
from .base import Generator

logger = logging.getLogger(__name__)


class Logger(Generator):
    """Wrap a generator: time each step and send the elapsed time and the
    step's inline observables to ``channel``.  The timer reads the host clock
    around the call, which on a GPU is the time to queue the step's work."""

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
        with Timer(self.channel if self.timer else None, f'{self.generator} step'):
            cfg, stats, inline = self.generator.step(generator, cfg, stats)
        if self.channel is not None:
            self.channel(inline)
        return cfg, stats, inline

    def report(self, stats):
        return self.generator.report(stats)
