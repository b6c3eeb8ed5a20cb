"""Generator combinators.

PyTorch counterparts of :class:`supervillain_tpu.generators.combining.Sequentially`
and ``KeepEvery``.  Where the JAX package folds a sub-step's index into its
key, a sub-step here draws from the one ``torch.Generator`` after the steps
before it, in order.
"""

from __future__ import annotations

import torch

from ..tracing import span
from .base import Generator


class Sequentially(Generator):
    """Compose generators into one step applied in order; stats merge (tags are
    de-duplicated as ``name#1``, ``name#2``, ...), inline observables union
    (later generators win on clashes).  Each sub-generator's step runs in a
    span ``update.<name>`` (:func:`..tracing.span`)."""

    def __init__(self, generators):
        self.generators = tuple(generators)
        for g in self.generators:
            if g.name not in g.init_stats():
                raise ValueError(
                    f'{type(g).__name__} keeps stats under tags '
                    f'{sorted(g.init_stats())}, not under its own name — it is '
                    'a self-contained composite; compose around it with '
                    'successive Ensemble.generate segments instead of '
                    'Sequentially.')
        seen = {}
        self._tags = []
        for g in self.generators:
            if g.name in seen:
                seen[g.name] += 1
                self._tags.append(f'{g.name}#{seen[g.name]}')
            else:
                seen[g.name] = 0
                self._tags.append(g.name)
        self.name = 'Sequentially(' + ', '.join(self._tags) + ')'

    def init_stats(self):
        return {tag: g.init_stats()[g.name] for g, tag in zip(self.generators, self._tags)}

    def inline_shapes(self):
        shapes = {}
        for g in self.generators:
            shapes.update(g.inline_shapes())
        return shapes

    def prepare(self, cfg):
        for g in self.generators:
            cfg = g.prepare(cfg)
        return cfg

    def step(self, generator, cfg, stats):
        inline = {}
        for g, tag in zip(self.generators, self._tags):
            # Present the sub-generator its stats under its own name.
            with span(f'update.{g.name}'):
                cfg, sub_stats, sub_inline = g.step(generator, cfg, {g.name: stats[tag]})
            stats = stats | {tag: sub_stats[g.name]}
            inline.update(sub_inline)
        return cfg, stats, inline


class KeepEvery(Generator):
    """Apply a generator ``n`` times per emitted configuration.

    ``blocked_inline=True`` averages the inline observables over the n sub-steps
    (promoted to at least float32, catching rare worm measurements); otherwise
    the last sub-step's inline values are kept, in their own dtype."""

    def __init__(self, n, generator, blocked_inline=True):
        self.n = int(n)
        self.generator = generator
        self.blocked_inline = bool(blocked_inline)
        self.name = generator.name

    def __str__(self):
        return f'KeepEvery({self.n}, {self.generator})'

    def init_stats(self):
        return self.generator.init_stats()

    def inline_shapes(self):
        return self.generator.inline_shapes()

    def prepare(self, cfg):
        return self.generator.prepare(cfg)

    def step(self, generator, cfg, stats):
        total = {}
        for _ in range(self.n):
            cfg, stats, inline = self.generator.step(generator, cfg, stats)
            if not self.blocked_inline:
                continue
            for k, v in inline.items():
                v = v.to(torch.promote_types(v.dtype, torch.float32))
                total[k] = v if k not in total else total[k] + v
        if self.blocked_inline:
            inline = {k: v / self.n for k, v in total.items()}
        return cfg, stats, inline

    def report(self, stats):
        return self.generator.report(stats)
