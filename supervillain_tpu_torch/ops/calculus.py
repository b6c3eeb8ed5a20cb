"""Discrete exterior calculus on the compact p-form layout, as ``torch.roll``
stencils.

PyTorch counterpart of :mod:`supervillain_tpu.ops.calculus`, restricted to the
four incidence operators the Villain main path uses.  Every operator is a static
Python loop over roll-and-accumulate terms generated from the lattice's
incidence tables.  Forms may carry leading batch axes: the component axis is
``-(D+1)`` and the spatial axes are the last D.  Integer inputs stay integer.
"""

from __future__ import annotations

from math import comb

import torch

from .lattice import Lattice

__all__ = ['d', 'delta', 'face_sum', 'coface_sum']


def _shift_accumulate(lattice: Lattice, op: str, p: int, f, out_degree: int, mode: str):
    """Shared engine.  ``mode`` selects the per-row term:

    * ``'fwd_diff'``:  sign * (roll(s, -1, axis) - s)        [d]
    * ``'bwd_diff'``: -sign * (s - roll(s, +1, axis))        [delta]
    * ``'fwd_sum'``:   s + roll(s, -1, axis)                 [coface_sum]
    * ``'bwd_sum'``:   s + roll(s, +1, axis)                 [face_sum]
    """
    D = lattice.D
    caxis = -(D + 1)
    terms = [None] * comb(D, out_degree)
    for out_idx, in_idx, axis, sign in lattice.operator_table(op, p):
        s = f.select(caxis, in_idx)
        ax = axis - D
        if mode == 'fwd_diff':
            t = sign * (torch.roll(s, -1, dims=ax) - s)
        elif mode == 'bwd_diff':
            t = (-sign) * (s - torch.roll(s, +1, dims=ax))
        elif mode == 'fwd_sum':
            t = s + torch.roll(s, -1, dims=ax)
        else:
            t = s + torch.roll(s, +1, dims=ax)
        terms[out_idx] = t if terms[out_idx] is None else terms[out_idx] + t
    return torch.stack(terms, dim=caxis)


def d(lattice: Lattice, p: int, f):
    r"""Exterior derivative of a p-form: ``(df)_O[x] = sum_j (-1)^j Δ_{o_j} f_{O\{o_j}}[x]``
    with the forward difference ``Δ_k A[x] = A[x+e_k] - A[x]``."""
    if p == lattice.D:
        return torch.zeros((), dtype=f.dtype, device=f.device)
    return _shift_accumulate(lattice, 'd', p, f, p + 1, 'fwd_diff')


def delta(lattice: Lattice, p: int, f):
    r"""Codifferential (formal adjoint of :func:`d`), from backward differences."""
    if p == 0:
        return torch.zeros((), dtype=f.dtype, device=f.device)
    return _shift_accumulate(lattice, 'delta', p, f, p - 1, 'bwd_diff')


def face_sum(lattice: Lattice, p: int, f):
    r"""Unsigned sum of a p-form onto its (p-1)-faces:
    ``g_M[x] = sum_{O ⊃ M} (f_O[x] + f_O[x - e_e])``.  Aggregates per-link ΔS
    onto sites in the Metropolis sweeps."""
    if p == 0:
        return torch.zeros((), dtype=f.dtype, device=f.device)
    return _shift_accumulate(lattice, 'face_sum', p, f, p - 1, 'bwd_sum')


def coface_sum(lattice: Lattice, p: int, f):
    r"""Unsigned sum of a p-form onto incident (p+1)-cofaces:
    ``g_O[x] = sum_{M ⊂ O} (f_M[x] + f_M[x + e_o])``."""
    if p == lattice.D:
        return torch.zeros((), dtype=f.dtype, device=f.device)
    return _shift_accumulate(lattice, 'coface_sum', p, f, p + 1, 'fwd_sum')
