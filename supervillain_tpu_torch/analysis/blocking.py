"""Blocking (binning) of consecutive configurations: a NumPy copy of
:mod:`supervillain_tpu.analysis.blocking` without its plotting method."""

from __future__ import annotations

import numpy as np

from ..io.data import ReadWriteable


class Blocking(ReadWriteable):
    r"""Average ('block') the observables of consecutive configurations.

    Parameters
    ----------
    ensemble: Ensemble
    width: int or 'auto'
        Samples per block; 'auto' uses the ensemble autocorrelation time.
    """

    def __init__(self, ensemble, width='auto'):
        self.Ensemble = ensemble
        if width == 'auto':
            self.width = ensemble.autocorrelation_time()
        else:
            self.width = width

        cfgs = len(ensemble)
        self.drop = cfgs % self.width
        self.blocks = (cfgs - self.drop) // self.width
        self.weight = np.asarray(ensemble.weight)[self.drop:].reshape(-1, self.width).mean(axis=1)
        self._block_indices = self.drop + np.arange(cfgs - self.drop).reshape(-1, self.width)
        self.index = self._block_indices.mean(axis=1)
        self.index_stride = ensemble.index_stride * self.width

    def __len__(self):
        return self.blocks

    def _block(self, obs):
        obs = np.asarray(obs)
        weight = np.asarray(self.Ensemble.weight)
        shape = obs.shape[1:]
        return (obs[self.drop:] * np.expand_dims(
            weight[self.drop:], axis=tuple(range(1, 1 + len(shape))))
        ).reshape(-1, self.width, *shape).mean(axis=1)

    def __getattr__(self, name):
        if name.startswith('__'):
            raise AttributeError(name)
        from ..observables import registry
        if name in registry:
            forward = getattr(self.Ensemble, name)
            self.__dict__[name] = self._block(forward)
            return self.__dict__[name]
        if name in self.Ensemble.__dict__:
            return self.Ensemble.__dict__[name]
        if name in ('autocorrelation_time',):
            return getattr(self.Ensemble, name)
        raise AttributeError(name)
