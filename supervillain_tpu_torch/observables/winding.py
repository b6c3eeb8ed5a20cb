"""Plaquette winding (counterpart of :mod:`supervillain_tpu.observables.winding`)."""

import torch

from ..ops import calculus as calc
from .core import Observable, Scalar


class WindingSquared(Scalar, Observable):
    r"""Lattice-averaged squared plaquette winding ``mean(dn²)`` (Villain)."""

    @staticmethod
    def Villain(S, n):
        if S.Lattice.D < 2:
            raise NotImplementedError('Winding observables require D >= 2.')
        dn = calc.d(S.Lattice, 1, n).to(torch.float64)
        return torch.mean(dn ** 2, dim=tuple(range(-(S.Lattice.D + 1), 0)))
