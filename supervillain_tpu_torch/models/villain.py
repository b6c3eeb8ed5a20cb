"""The Villain action for the compact boson.

PyTorch counterpart of :mod:`supervillain_tpu.models.villain`.  A field
configuration is a dict ``{'phi': (..., 1, N, ..., N) float, 'n': (..., D, N, ..., N)
int}``; any leading axes are a batch of configurations.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import field_dtypes, resolve_device
from ..ops import Lattice
from ..ops.lattice import lattice_from_h5
from ..ops import calculus as calc


class Villain:
    r"""The Villain action

    .. math::
        S[\phi, n] = \frac{\kappa}{2} \sum_\ell (d\phi - 2\pi n)_\ell^2

    with φ a real 0-form on sites and n an integer 1-form on links, subject to the
    winding constraint ``dn ≡ 0 mod W`` (``dn = 0`` exactly when W=∞).
    """

    fields = ('phi', 'n')

    def __init__(self, lattice: Lattice, kappa: float, W=1):
        if not isinstance(lattice, Lattice):
            raise TypeError(f'Villain requires a Lattice, got {type(lattice).__name__}')
        if not (W == float('inf') or (float(W).is_integer() and W >= 1)):
            raise ValueError(f'W must be a positive integer or inf, got {W}')
        self.Lattice = lattice
        self.kappa = float(kappa)
        self.W = (float('inf') if W == float('inf') else int(W))

    def __str__(self):
        return f'Villain({self.Lattice}, κ={self.kappa}, W={self.W})'

    __repr__ = __str__

    def __eq__(self, other):
        return (isinstance(other, Villain)
                and (self.Lattice, self.kappa, self.W) == (other.Lattice, other.kappa, other.W))

    def __hash__(self):
        return hash(('Villain', self.Lattice, self.kappa, self.W))

    def _form_axes(self):
        return tuple(range(-(self.Lattice.D + 1), 0))

    def __call__(self, phi, n):
        r"""S[φ, n], one value per configuration of the batch."""
        return (self.kappa / 2) * torch.sum(self.links(phi, n) ** 2, dim=self._form_axes())

    def links(self, phi, n):
        r"""Gauge-invariant link variables ``dφ - 2πn`` as a 1-form."""
        return calc.d(self.Lattice, 0, phi) - 2 * np.pi * n.to(phi.dtype)

    def local(self, phi, n):
        r"""Per-link action density ``(κ/2)(dφ - 2πn)²`` as a 1-form."""
        return (self.kappa / 2) * self.links(phi, n) ** 2

    def initial(self, device='cuda'):
        """The cold (all-zero) configuration on ``device``, in its :func:`field_dtypes`."""
        device = resolve_device(device)
        fdt, idt = field_dtypes(device)
        L = self.Lattice
        return {'phi': torch.zeros(L.form_shape(0), dtype=fdt, device=device),
                'n': torch.zeros(L.form_shape(1), dtype=idt, device=device)}

    def field_degrees(self):
        return {'phi': 0, 'n': 1}

    def configurations(self, count):
        """Host-side zeroed storage for ``count`` configurations."""
        from ..configurations import Configurations
        L = self.Lattice
        return Configurations({'phi': np.zeros((count,) + L.form_shape(0)),
                               'n': np.zeros((count,) + L.form_shape(1), dtype=int)})

    def gauge_transform(self, configuration, k):
        r"""φ → φ + 2πk, n → n + dk for an integer 0-form k; the combination
        ``dφ - 2πn`` is invariant."""
        k = torch.as_tensor(k)
        if k.is_floating_point() or k.is_complex() or k.dtype == torch.bool:
            raise ValueError('The gauge transformation is generated by integer k.')
        phi, n = configuration['phi'], configuration['n']
        k = k.to(n.device)
        return dict(configuration) | {'phi': phi + 2 * np.pi * k.to(phi.dtype),
                                      'n': n + calc.d(self.Lattice, 0, k).to(n.dtype)}

    def valid(self, configuration):
        r"""Is ``dn ≡ 0 mod W`` satisfied everywhere (``dn = 0`` when W=∞)?"""
        dn = calc.d(self.Lattice, 1, configuration['n'])
        zero = torch.remainder(dn, self.W) if self.W < float('inf') else dn
        return bool((zero == 0).all())

    def to_h5(self, group):
        group.attrs['type'] = 'Villain'
        self.Lattice.to_h5(group.create_group('lattice'))
        group['kappa'] = self.kappa
        group['W'] = self.W

    @classmethod
    def from_h5(cls, group):
        W = float(np.asarray(group['W']))
        return cls(lattice_from_h5(group['lattice']), float(np.asarray(group['kappa'])),
                   W if W == float('inf') else int(W))
