"""Vortex-correlator observables (counterpart of :mod:`supervillain_tpu.observables.vortex`)."""

import numpy as np
import torch

from ..device import complex_dtype
from .core import Observable, DerivedQuantity, Constrained, at_origin, per_draw, spatial_sum
from ._taxicab import taxicab_mean, vortex_tables


class Vortex_Vortex(Constrained, Observable):
    r"""``V_Δx = (1/Λ) Σ_x ⟨e^{2πi(v_x - v_{x-Δx})/W}⟩``.

    Worldline: direct correlation of ``e^{2πiv/W}``, orientation-averaged, any
    D.  Villain: dual-lattice taxicab reweighting, D=2 only (the inline worm
    histogram is the dimension-general route)."""

    sequential = True

    @staticmethod
    def Worldline(S, v):
        L = S.Lattice
        if L.D < 2:
            raise NotImplementedError('Vortex observables require D >= 2.')
        vortex = torch.exp(2j * np.pi * v.to(complex_dtype(v.device)) / S._W)
        return L.correlation(vortex, vortex).mean(dim=-(L.D + 1))

    @staticmethod
    def Villain(S, Links):
        if S.Lattice.D != 2:
            raise NotImplementedError(
                'The Villain Vortex_Vortex taxicab measurement is only implemented for D=2.')
        kappa = S.kappa
        return taxicab_mean(Links, vortex_tables(2, S.Lattice.N),
                            lambda Pn, length: torch.exp(2 * np.pi * kappa * (Pn - np.pi * length)))

    @staticmethod
    def CriticalScalingDimension(S):
        r"""``Δ = 2/W²`` (finite W); ``4πκ`` (W=∞)."""
        if S.W < float('inf'):
            return 2 / S.W ** 2
        return 4 * np.pi * S.kappa


class Vortex_Vortex_Normalized(DerivedQuantity):
    r"""``Vortex_Vortex / Vortex_Vortex[origin]``."""

    @staticmethod
    def default(S, Vortex_Vortex):
        return Vortex_Vortex / per_draw(at_origin(Vortex_Vortex, S.Lattice), S.Lattice)


class VortexSusceptibility(DerivedQuantity):
    r"""``χ_V = Σ_r Re Vortex_Vortex_Normalized(r)``."""

    @staticmethod
    def default(S, Vortex_Vortex_Normalized):
        return spatial_sum(Vortex_Vortex_Normalized.real, S.Lattice)


class VortexSusceptibilityScaled(VortexSusceptibility):
    r"""``χ_V / L^{D - 2Δ(κ_c, W)}``."""

    @staticmethod
    def default(S, VortexSusceptibility):
        L = S.Lattice
        return VortexSusceptibility / L.N ** (L.D - 2 * Vortex_Vortex.CriticalScalingDimension(S))


class VortexCriticalMoment(DerivedQuantity):
    r"""``C_V = (1/L^D) Σ_r r^{2Δ} V(r)``."""

    @staticmethod
    def default(S, Vortex_Vortex_Normalized):
        L = S.Lattice
        weight = torch.as_tensor(L.R_squared ** Vortex_Vortex.CriticalScalingDimension(S),
                                 dtype=Vortex_Vortex_Normalized.real.dtype,
                                 device=Vortex_Vortex_Normalized.device)
        return spatial_sum(weight * Vortex_Vortex_Normalized.real, L) / L.sites
