"""Torus-wrapping observables (counterpart of
:mod:`supervillain_tpu.observables.wrapping`)."""

import torch

from ..device import float_dtype_of
from .core import Observable, Scalar


class TorusWrapping(Observable):
    r"""Global winding per direction: Villain ``Σ n_μ``; Worldline ``Σ m_μ / N``.
    Does not match across formulations (different physical content)."""

    @staticmethod
    def Villain(S, phi, n):
        return n.sum(dim=tuple(range(-S.Lattice.D, 0)))

    @staticmethod
    def Worldline(S, m):
        return m.sum(dim=tuple(range(-S.Lattice.D, 0))).to(float_dtype_of(m)) / S.Lattice.N


class WrappingSquared(Scalar, Observable):
    r"""``Σ_μ TorusWrapping_μ²``: positive semi-definite topological fluctuation."""

    @staticmethod
    def default(S, TorusWrapping):
        w = TorusWrapping.to(float_dtype_of(TorusWrapping))
        return torch.sum(w ** 2, dim=-1)
