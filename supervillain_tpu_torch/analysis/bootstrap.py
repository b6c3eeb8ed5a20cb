"""Weighted bootstrap resampling: a NumPy copy of
:class:`supervillain_tpu.analysis.Bootstrap` without its plotting and HDF5
methods."""

from __future__ import annotations

import numpy as np


class Bootstrap:
    r"""Bootstrap resampling with weights: per draw,
    ``⟨O⟩ = ⟨Ow⟩ / ⟨w⟩`` tracks numerator/denominator correlations; resampling the
    same index matrix across observables preserves cross-observable correlations.
    Primary observables forward to the underlying ensemble and are resampled
    transparently."""

    def __init__(self, ensemble, draws=100, seed=None):
        self.Ensemble = ensemble
        self.Action = ensemble.Action
        self.draws = draws
        cfgs = len(ensemble)
        rng = np.random.default_rng(seed)
        self.indices = rng.integers(0, cfgs, (cfgs, draws))

    def __len__(self):
        return self.draws

    def _resample(self, obs):
        obs = np.asarray(obs)
        w = np.asarray(self.Ensemble.weight)[self.indices]
        # draw-major result: (draws, ...) matching the ensemble's (cfgs, ...) layout.
        return np.einsum('...d->d...',
                         np.einsum('cd,cd...->c...d', w, obs[self.indices]).mean(axis=0)
                         / w.mean(axis=0))

    def __getattr__(self, name):
        if name.startswith('__'):
            raise AttributeError(name)
        try:
            forward = getattr(self.Ensemble, name)
        except Exception as e:
            raise AttributeError(f"'Bootstrap' object has no attribute '{name}'") from e
        self.__dict__[name] = self._resample(forward)
        return self.__dict__[name]

    def estimate(self, observable):
        """(central value, uncertainty) for the named observable."""
        o = getattr(self, observable)
        return (np.mean(o, axis=0), np.std(o, axis=0))
