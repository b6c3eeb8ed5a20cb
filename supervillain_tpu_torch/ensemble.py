"""Markov chains of configurations: a Python loop over generator steps.

PyTorch counterpart of :mod:`supervillain_tpu.ensemble`.  The chain runs on the
device of its fields; each step's fields and inline observables land on the
host as NumPy columns, and observables attach through the registry
descriptors of :mod:`.observables`.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .configurations import Configurations

logger = logging.getLogger(__name__)


def _no_op(iterable, **kwargs):
    return iterable


class Ensemble:
    """An ensemble of configurations importance-sampled according to ``action``."""

    def __init__(self, action):
        self.Action = action

    def from_configurations(self, configurations):
        self.configuration = configurations
        if not hasattr(self, 'index'):
            self.index = np.arange(len(configurations))
            self.index_stride = 1
            self.weight = np.ones(len(configurations))
        return self

    def generate(self, steps, generator, start='cold', seed=0, device='cpu',
                 progress=_no_op, starting_index=0, index_stride=1):
        """Run the chain for ``steps`` configurations.

        ``generator`` provides ``step(torch_generator, cfg, stats)``; ``seed``
        seeds a ``torch.Generator`` on ``device``, where the chain runs.
        ``start`` is ``'cold'`` or a configuration dict (moved to ``device``)."""
        S = self.Action
        rng = torch.Generator(device=device).manual_seed(int(seed))
        if start == 'cold':
            cfg = S.initial(device)
        elif isinstance(start, dict):
            cfg = {k: torch.as_tensor(start[k], device=device) for k in S.fields}
        else:
            raise ValueError(f'Not sure how to start from a {type(start)}.')

        stats = generator.init_stats()
        columns = None
        for i in progress(range(steps), desc='Generation'):
            cfg, stats, inline = generator.step(rng, cfg, stats)
            host = {k: v.detach().cpu().numpy() for k, v in (cfg | inline).items()}
            if columns is None:
                columns = {k: np.empty((steps,) + v.shape, dtype=v.dtype) for k, v in host.items()}
            for k, v in host.items():
                columns[k][i] = v

        self.configuration = Configurations(columns)
        self.index_stride = index_stride
        self.index = starting_index + index_stride * np.arange(steps)
        self.weight = np.ones(steps)
        self.start = start
        self.generator = generator
        self.stats = stats
        for line in generator.report(stats).split('\n'):
            logger.info(line)
        return self

    def __len__(self):
        return len(self.configuration)

    def __getattr__(self, name):
        # Field columns are exposed as ensemble attributes, unifying observables'
        # access to fields and other observables.
        if name.startswith('__'):
            raise AttributeError(name)
        try:
            return getattr(self.__dict__['configuration'], name)
        except KeyError:
            raise AttributeError(name) from None

    @property
    def measured(self):
        from .observables import registry
        return self.__dict__.keys() & registry.keys()

    def autocorrelation_time(self, observables=None, every=False):
        """Max integrated autocorrelation time over fluctuating measured observables,
        falling back to half the ensemble length when nothing fluctuates."""
        from .observables import registry
        from .analysis import autocorrelation_time

        if observables is None:
            observables = set(o for o in self.measured if registry[o].autocorrelation(self))
        if len(observables) == 0:
            observables = tuple(registry.keys())

        auto = {}
        for name in observables:
            if not registry[name].autocorrelation(self):
                continue
            try:
                auto[name] = autocorrelation_time(getattr(self, name))
            except NotImplementedError:
                continue
            except ValueError:
                logger.warning(f'{name} does not fluctuate enough; excluded from '
                               'the autocorrelation time calculation.')

        if every:
            return auto
        if not auto:
            tau = max(1, int(np.ceil(len(self) / 2)))
            logger.warning('No observable fluctuated enough to estimate an '
                           f'autocorrelation time; falling back to τ = {tau}.')
            return tau
        return max(auto.values())

    def _derive(self, index):
        e = Ensemble(self.Action).from_configurations(self.configuration[index])
        e.index = self.index[index]
        e.weight = self.weight[index]
        for o in self.measured:
            setattr(e, o, getattr(self, o)[index])
        return e

    def cut(self, start):
        """Drop the first ``start`` configurations (thermalization)."""
        e = self._derive(slice(start, None))
        e.index_stride = self.index_stride
        return e

    def every(self, stride):
        """Keep every ``stride``-th configuration (decorrelation)."""
        stride = int(stride)
        if stride < 1:
            raise ValueError(f'every() needs a stride >= 1, got {stride}.')
        e = self._derive(slice(None, None, stride))
        e.index_stride = self.index_stride * stride
        return e
