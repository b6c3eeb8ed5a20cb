"""The interlaced (2N)^D embedding of compact p-forms, for :class:`~.form.Form`.

The port's copy of the two embedding functions of
:mod:`supervillain_tpu.ops.interlaced`; the interlaced calculus there is a test
oracle and stays in the JAX package.  A p-form component with direction set I
lives at interlaced coordinates ``ξ_k = 2 x_k + [k ∈ I]``: even coordinates are
site directions, odd ones the directions the cell spans.
"""

from __future__ import annotations

import numpy as np

from .lattice import Lattice


def _cells(lattice: Lattice, comp):
    return tuple(slice(1 if k in comp else 0, None, 2) for k in range(lattice.D))


def to_interlaced(lattice: Lattice, p: int, f) -> np.ndarray:
    """Embed a compact p-form (C(D,p), N, ..., N) into a (2N)^D interlaced array."""
    f = np.asarray(f)
    out = np.zeros((2 * lattice.N,) * lattice.D, dtype=f.dtype)
    for comp, idx in lattice.comp_index[p].items():
        out[_cells(lattice, comp)] = f[idx]
    return out


def from_interlaced(lattice: Lattice, p: int, F) -> np.ndarray:
    """Extract the compact p-form from an interlaced (2N)^D array."""
    F = np.asarray(F)
    out = np.zeros(lattice.form_shape(p), dtype=F.dtype)
    for comp, idx in lattice.comp_index[p].items():
        out[idx] = F[_cells(lattice, comp)]
    return out
