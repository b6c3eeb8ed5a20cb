"""Discrete exterior calculus on the compact p-form layout, as ``torch.roll``
stencils.

PyTorch counterpart of :mod:`supervillain_tpu.ops.calculus`: the four
incidence operators, the Laplacian, the Hodge star, the wedge product, the
translations ``push``/``pull`` and ``inner``, in any dimension D.  Every
operator is a static Python loop over roll-and-accumulate terms generated from
the lattice's incidence tables, run on the device of its input.  Forms may
carry leading batch axes: the component axis is ``-(D+1)`` and the spatial axes
are the last D.  Integer inputs stay integer.
"""

from __future__ import annotations

from itertools import combinations
from math import comb

import torch

from .lattice import Lattice

__all__ = ['d', 'delta', 'face_sum', 'coface_sum', 'laplacian', 'star', 'wedge', 'push',
           'pull', 'inner']


def _sorting_sign(seq) -> int:
    """Sign of the permutation sorting a sequence of distinct integers."""
    inversions = sum(1 for i in range(len(seq)) for j in range(i + 1, len(seq))
                     if seq[i] > seq[j])
    return -1 if inversions % 2 else +1


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


def laplacian(lattice: Lattice, p: int, f):
    r"""Hodge–de Rham Laplacian ``Δ = dδ + δd`` as its component-diagonal
    nearest-neighbor stencil ``(Δf)_I[x] = Σ_k (2 f_I[x] − f_I[x+e_k] − f_I[x−e_k])``
    (the cross terms cancel on the flat torus).  Preserves the dtype."""
    D = lattice.D
    result = (2 * D) * f
    for k in range(D):
        result = result - torch.roll(f, -1, dims=k - D) - torch.roll(f, +1, dims=k - D)
    return result


def star(lattice: Lattice, p: int, f):
    r"""Hodge star of a p-form, a (D-p)-form:
    ``(★f)_J[x] = σ(I⌢J) f_I[x − e_I]`` with I the complement of J and the
    alignment shift ``e_I = Σ_{k∈I} e_k``."""
    D = lattice.D
    caxis = -(D + 1)
    out = []
    for J in lattice.components[D - p]:
        I = tuple(k for k in range(D) if k not in J)
        s = f.select(caxis, lattice.comp_index[p][I])
        if I:
            s = torch.roll(s, [1] * len(I), dims=[k - D for k in I])
        out.append(_sorting_sign(I + J) * s)
    return torch.stack(out, dim=caxis)


def wedge(lattice: Lattice, pa: int, a, pb: int, b):
    r"""Wedge product of a pa-form and a pb-form, a (pa+pb)-form:
    ``(a ∧ b)_O[x] = Σ_{O = A ⊔ B} σ(A⌢B) a_A[x] b_B[x + e_A]``."""
    D = lattice.D
    if pa + pb > D:
        raise ValueError(f'Cannot wedge a {pa}-form and a {pb}-form in D={D}')
    caxis = -(D + 1)
    out = []
    for O in lattice.components[pa + pb]:
        acc = None
        for A in combinations(O, pa):
            B = tuple(k for k in O if k not in A)
            sign = (-1) ** sum(1 for k in A for j in B if j < k)
            b_part = b.select(caxis, lattice.comp_index[pb][B])
            for k in A:
                b_part = torch.roll(b_part, -1, dims=k - D)
            term = sign * (a.select(caxis, lattice.comp_index[pa][A]) * b_part)
            acc = term if acc is None else acc + term
        out.append(acc)
    return torch.stack(out, dim=caxis)


def push(form, shift):
    r"""Translate forward: ``push(f, Δx)[..., x] = f[..., x − Δx]`` (periodic),
    over the last ``len(shift)`` axes."""
    result = torch.as_tensor(form)
    for i, s in enumerate(shift):
        if s:
            result = torch.roll(result, int(s), dims=i - len(shift))
    return result


def pull(form, shift):
    r"""Translation operator ``T_Δx``: ``pull(f, Δx)[..., x] = f[..., x + Δx]``."""
    return push(form, tuple(-s for s in shift))


def inner(a, b):
    """Componentwise inner product ``⟨a, b⟩ = Σ_{I,x} a_I[x] b_I[x]`` over
    every axis."""
    return torch.sum(a * b)
