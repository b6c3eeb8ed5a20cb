"""Weighted bootstrap resampling (counterpart of
:class:`supervillain_tpu.analysis.Bootstrap`).

The resampling runs on the ensemble's device (the card unless the ensemble was
made with ``device='cpu'``) as one matrix product: with ``K[j, d]`` the number
of times configuration j appears in draw d and w the configurations' weights,
a draw's weighted mean of every observable at once is
``((K·w)ᵀ @ O) / (Kᵀ @ w)`` for the (configurations, features) matrix O.  This
is the JAX package's ``Σ_c w O / Σ_c w`` over the index matrix, summed in
another order.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..device import to_device
from ..observables.core import measurement_device
from ..utils import Timer

logger = logging.getLogger(__name__)


class Bootstrap:
    r"""Bootstrap resampling with weights: per draw,
    ``⟨O⟩ = ⟨Ow⟩ / ⟨w⟩`` tracks numerator/denominator correlations; resampling the
    same index matrix across observables preserves cross-observable correlations.

    Derived quantities attach here as descriptors; primary observables forward
    to the underlying ensemble and are resampled transparently.  The same
    ``seed`` draws the same ``indices`` as the JAX package's Bootstrap.
    """

    def __init__(self, ensemble, draws=100, seed=None):
        self.Ensemble = ensemble
        self.Action = ensemble.Action
        self.draws = draws
        cfgs = len(ensemble)
        rng = np.random.default_rng(seed)
        self.indices = rng.integers(0, cfgs, (cfgs, draws))

    def __len__(self):
        return self.draws

    @property
    def device(self):
        """The device the resampling and derived quantities run on: the ensemble's."""
        return getattr(self.Ensemble, 'device', 'cuda')

    def _weights(self, device):
        """(K·w)ᵀ, shape (draws, configurations), and its row sums Kᵀ @ w, on
        ``device``; built once per device."""
        key = ('_weights', str(device))
        if key not in self.__dict__:
            indices = torch.as_tensor(self.indices, device=device)
            w = to_device(np.asarray(self.Ensemble.weight, dtype=float), device)
            counts = torch.zeros((len(w), self.draws), dtype=w.dtype, device=device)
            counts.scatter_add_(0, indices, torch.ones_like(indices, dtype=w.dtype))
            kw = (counts * w[:, None]).T.contiguous()
            self.__dict__[key] = (kw, kw.sum(dim=1))
        return self.__dict__[key]

    def _resample(self, obs):
        device = measurement_device(self)
        obs = to_device(np.asarray(obs), device)
        kw, norm = self._weights(device)
        flat = torch.view_as_real(obs) if obs.is_complex() else obs
        flat = flat.reshape(len(obs), -1).to(kw.dtype)
        means = (kw @ flat) / norm[:, None]
        if obs.is_complex():
            means = torch.view_as_complex(means.reshape(self.draws, -1, 2))
        # draw-major result: (draws, ...) matching the ensemble's (cfgs, ...) layout.
        return means.reshape((self.draws,) + tuple(obs.shape[1:])).cpu().numpy()

    def __getattr__(self, name):
        if name.startswith('_'):
            raise AttributeError(name)
        with Timer(logger.info, f'Bootstrapping {name}', per=len(self)):
            try:
                forward = getattr(self.Ensemble, name)
            except Exception as e:
                raise AttributeError(f"'Bootstrap' object has no attribute '{name}'") from e
            self.__dict__[name] = self._resample(forward)
            return self.__dict__[name]

    def estimate(self, observable):
        """(central value, uncertainty) for the named observable or derived quantity."""
        o = getattr(self, observable)
        return (np.mean(o, axis=0), np.std(o, axis=0))

    # -- plotting ----------------------------------------------------------
    # Each method brings the draws to the host once, as a NumPy array, for
    # the axis; matplotlib is the caller's (only the axis is touched).

    def plot_band(self, axis, observable, color=None):
        """Horizontal ±1σ band for a scalar observable."""
        data = np.asarray(getattr(self, observable))
        mean = data.mean(axis=0)
        err = data.std(axis=0)
        if np.shape(mean) != ():
            raise ValueError(f'{observable} has shape {np.shape(mean)}')
        if color is None:
            color = axis.get_lines()[-1].get_color()
        axis.axhspan(mean - err, mean + err, color=color, alpha=0.5, linestyle='none')

    def plot_correlator(self, axis, correlator, offset=0., symmetrize=True,
                        multiplier=1., linestyle='none', marker='o',
                        markerfacecolor='none', **kwargs):
        """Correlator vs |Δx| with error bars, optionally point-group symmetrized."""
        L = self.Ensemble.Action.Lattice
        dx = L.linearize(L.R_squared) ** 0.5
        C = np.asarray(getattr(self, correlator)).real
        if symmetrize:
            C = L.symmetrize(C)
        axis.errorbar(dx + offset,
                      multiplier * np.asarray(L.linearize(C.mean(axis=0))),
                      multiplier * np.asarray(L.linearize(C.std(axis=0))),
                      linestyle=linestyle, marker=marker,
                      markerfacecolor=markerfacecolor, **kwargs)
        axis.set_xlabel('∆x')

    # -- persistence --------------------------------------------------------

    def to_h5(self, group):
        self.Action.to_h5(group.create_group('action'))
        group['indices'] = self.indices
        group['draws'] = self.draws
        from ..observables import derived_registry, registry
        measured = group.create_group('measured')
        for name in (registry.keys() | derived_registry.keys()) & self.__dict__.keys():
            value = self.__dict__[name]
            if np.iscomplexobj(value):
                g = measured.create_group(name)
                g['real'] = value.real
                g['imag'] = value.imag
            else:
                measured[name] = value

    @classmethod
    def from_h5(cls, group, ensemble):
        import h5py
        boot = cls.__new__(cls)
        boot.Ensemble = ensemble
        boot.Action = ensemble.Action
        boot.draws = int(np.asarray(group['draws']))
        boot.indices = np.asarray(group['indices'])
        if 'measured' in group:
            for name in group['measured']:
                node = group['measured'][name]
                if isinstance(node, h5py.Group):
                    boot.__dict__[name] = np.asarray(node['real']) + 1j * np.asarray(node['imag'])
                else:
                    boot.__dict__[name] = np.asarray(node)
        return boot
