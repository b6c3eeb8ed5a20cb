"""The dual (worldline) action for the compact boson.

PyTorch counterpart of :mod:`supervillain_tpu.models.worldline`.  A field
configuration is a dict ``{'m': (..., D, N, ..., N) int, 'v': (..., C(D,2), N,
..., N) int}`` (v is float when W=∞), subject to ``δm = 0`` on every site; any
leading axes are a batch of configurations.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import field_dtypes, float_dtype_of, resolve_device
from ..ops import Lattice
from ..ops import calculus as calc


class Worldline:
    r"""The worldline action

    .. math::
        S[m, v] = \frac{1}{2\kappa} \sum_\ell \left(m - \frac{\delta v}{W}\right)_\ell^2
                  + \frac{|\ell|}{2}\ln(2\pi\kappa) - |x|\ln 2\pi

    summed over configurations with ``δm = 0`` everywhere.  Internally
    ``_W = W`` (finite) or ``2π`` (W=∞).
    """

    fields = ('m', 'v')

    def __init__(self, lattice: Lattice, kappa: float, W=1):
        if not isinstance(lattice, Lattice):
            raise TypeError(f'Worldline requires a Lattice, got {type(lattice).__name__}')
        if not (W == float('inf') or (float(W).is_integer() and W >= 1)):
            raise ValueError(f'W must be a positive integer or inf, got {W}')
        self.Lattice = lattice
        self.kappa = float(kappa)
        self.W = (float('inf') if W == float('inf') else int(W))
        self._W = (self.W if self.W < float('inf') else 2 * np.pi)
        self._constant_offset = (
            lattice.links / 2 * np.log(2 * np.pi * kappa) - lattice.sites * np.log(2 * np.pi))

    def __str__(self):
        return f'Worldline({self.Lattice}, κ={self.kappa}, W={self.W})'

    __repr__ = __str__

    def __eq__(self, other):
        return (isinstance(other, Worldline)
                and (self.Lattice, self.kappa, self.W) == (other.Lattice, other.kappa, other.W))

    def __hash__(self):
        return hash(('Worldline', self.Lattice, self.kappa, self.W))

    def _form_axes(self):
        return tuple(range(-(self.Lattice.D + 1), 0))

    def links(self, m, v):
        r"""Gauge-invariant link variables ``m - δv/W`` as a float 1-form."""
        fdt = float_dtype_of(v)
        return m.to(fdt) - calc.delta(self.Lattice, 2, v).to(fdt) / self._W

    def energy(self, m, v):
        r"""The field-dependent part of S plus its constant (no constraint check)."""
        u = self.links(m, v)
        return 0.5 / self.kappa * torch.sum(u ** 2, dim=self._form_axes()) + self._constant_offset

    def __call__(self, m, v):
        r"""S[m, v]; raises ValueError if ``δm ≠ 0`` anywhere."""
        if not self.valid({'m': m}):
            raise ValueError('The one-form m does not satisfy δm = 0 everywhere.')
        return self.energy(m, v)

    def initial(self, device='cuda'):
        """The cold (all-zero) configuration on ``device``: int m, and v int at
        finite W or float at W=∞, in the device's :func:`field_dtypes`."""
        device = resolve_device(device)
        fdt, idt = field_dtypes(device)
        L = self.Lattice
        return {'m': torch.zeros(L.form_shape(1), dtype=idt, device=device),
                'v': torch.zeros(L.form_shape(2), dtype=idt if self.W < float('inf') else fdt,
                                 device=device)}

    def valid(self, configuration):
        r"""Is ``δm = 0`` satisfied on every site?"""
        return bool((calc.delta(self.Lattice, 1, configuration['m']) == 0).all())

    def equivalence_class_v(self, configuration):
        r"""Gauge-fix v into [0, W): v → v - λW, m → m - δλ with λ = floor(v/W),
        which leaves the links m - δv/W unchanged.  No-op when W=∞."""
        if self.W == float('inf'):
            return configuration
        v = configuration['v']
        lam = torch.div(v, self.W, rounding_mode='floor')
        return dict(configuration) | {'m': configuration['m'] - calc.delta(self.Lattice, 2, lam),
                                      'v': torch.remainder(v, self.W)}
