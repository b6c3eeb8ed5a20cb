"""Plaquette-winding observables (counterpart of
:mod:`supervillain_tpu.observables.winding`)."""

import numpy as np
import torch

from ..device import float_dtype_of
from ..ops import calculus as calc
from .core import Observable, Scalar


def _require_plaquettes(S):
    if S.Lattice.D < 2:
        raise NotImplementedError('Winding observables require D >= 2.')


def _form_mean(x, lattice):
    return torch.mean(x, dim=tuple(range(-(lattice.D + 1), 0)))


class WindingSquared(Scalar, Observable):
    r"""Lattice-averaged squared plaquette winding:
    Villain ``mean(dn²)``; Worldline ``1/(π²κ) - mean(d Links²)/(2πκ)²``."""

    @staticmethod
    def Villain(S, n):
        _require_plaquettes(S)
        dn = calc.d(S.Lattice, 1, n).to(float_dtype_of(n))
        return _form_mean(dn ** 2, S.Lattice)

    @staticmethod
    def Worldline(S, Links):
        _require_plaquettes(S)
        dm = calc.d(S.Lattice, 1, Links)
        return 1 / (np.pi ** 2 * S.kappa) - _form_mean(dm ** 2, S.Lattice) / (2 * np.pi * S.kappa) ** 2


class Winding_Winding(Observable):
    r"""Translation-averaged plaquette-winding correlator, orientation-averaged
    over the C(D,2) components.  The Worldline measurement needs the
    J-independent dδ contact stencil (orientation-averaged diagonal; minus the
    5-point Laplacian in 2D), cached per (D, N) as a host array."""

    _stencil = {}

    @staticmethod
    def Villain(S, n):
        _require_plaquettes(S)
        L = S.Lattice
        dn = calc.d(L, 1, n).to(float_dtype_of(n))
        return L.correlation(dn, dn).real.mean(dim=-(L.D + 1))

    @staticmethod
    def contact(L):
        """The orientation-averaged diagonal of dδ on 2-forms, shape (N, ..., N)."""
        key = (L.D, L.N)
        if key not in Winding_Winding._stencil:
            # A unit source on component c at the origin, dδ applied, component
            # c read back, averaged over c.
            orientations = len(L.components[2])
            sources = torch.zeros((orientations,) + L.form_shape(2), dtype=torch.float64)
            for c in range(orientations):
                sources[(c, c) + L.origin] = 1.0
            dd = calc.d(L, 1, calc.delta(L, 2, sources))
            Winding_Winding._stencil[key] = np.mean(
                [dd[c, c].numpy() for c in range(orientations)], axis=0)
        return Winding_Winding._stencil[key]

    @staticmethod
    def Worldline(S, Links):
        _require_plaquettes(S)
        L = S.Lattice
        kappa = S.kappa
        dm = calc.d(L, 1, Links)
        contact = torch.as_tensor(Winding_Winding.contact(L), dtype=Links.dtype,
                                  device=Links.device)
        return (kappa * contact - L.correlation(dm, dm).real.mean(dim=-(L.D + 1))) \
            / (2 * np.pi * kappa) ** 2
