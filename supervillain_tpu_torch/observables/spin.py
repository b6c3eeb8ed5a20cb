"""Spin-correlator observables (counterpart of :mod:`supervillain_tpu.observables.spin`)."""

import numpy as np
import torch

from ..device import complex_dtype
from .core import Observable, DerivedQuantity, at_origin, per_draw, spatial_sum
from ._taxicab import spin_tables, taxicab_mean


class Spin_Spin(Observable):
    r"""The boson two-point function reduced to a single relative coordinate,
    ``Spin_Spin_Δx = (1/Λ) Σ_x S_{x, x-Δx}``.

    Villain: ``L.correlation(e^{iφ}, e^{iφ})``, any D, normalized to 1 at the
    origin.  Worldline: taxicab defect reweighting
    ``exp(-(1/2κ) Σ_{ℓ∈P} (2 P m + P²))`` averaged over translations, D=2 only
    (the inline worm histogram is the dimension-general route)."""

    sequential = True  # gather-heavy; measured over bounded chunks of draws

    @staticmethod
    def Villain(S, phi):
        L = S.Lattice
        spin = torch.exp(1j * phi[:, 0].to(complex_dtype(phi.device)))
        return L.correlation(spin, spin)

    @staticmethod
    def Worldline(S, Links):
        if S.Lattice.D != 2:
            raise NotImplementedError(
                'The Worldline Spin_Spin taxicab measurement is only implemented for D=2.')
        kappa = S.kappa
        return taxicab_mean(Links, spin_tables(2, S.Lattice.N),
                            lambda Pm, length: torch.exp(-1 / (2 * kappa) * (2 * Pm + length)))

    @staticmethod
    def CriticalScalingDimension(S):
        r"""``Δ = W²/8`` (finite W); ``1/πκ`` (W=∞)."""
        if S.W < float('inf'):
            return S.W ** 2 / 8
        return 1 / S.kappa / np.pi


class Spin_Spin_Normalized(DerivedQuantity):
    r"""``Spin_Spin / Spin_Spin[origin]``: normalizes inline worm histograms,
    which can only be normalized after the bootstrap."""

    @staticmethod
    def default(S, Spin_Spin):
        return Spin_Spin / per_draw(at_origin(Spin_Spin, S.Lattice), S.Lattice)


class SpinSusceptibility(DerivedQuantity):
    r"""``χ_S = Σ_r Re Spin_Spin_Normalized(r)``."""

    @staticmethod
    def default(S, Spin_Spin_Normalized):
        return spatial_sum(Spin_Spin_Normalized.real, S.Lattice)


class SpinSusceptibilityScaled(SpinSusceptibility):
    r"""``χ_S / L^{D - 2Δ(κ_c)}``: constant at criticality in the large-L limit."""

    @staticmethod
    def default(S, SpinSusceptibility):
        L = S.Lattice
        return SpinSusceptibility / L.N ** (L.D - 2 * Spin_Spin.CriticalScalingDimension(S))


class SpinCriticalMoment(DerivedQuantity):
    r"""``C_S = (1/L^D) Σ_r r^{2Δ} S(r)``."""

    @staticmethod
    def default(S, Spin_Spin_Normalized):
        L = S.Lattice
        weight = torch.as_tensor(L.R_squared ** Spin_Spin.CriticalScalingDimension(S),
                                 dtype=Spin_Spin_Normalized.real.dtype,
                                 device=Spin_Spin_Normalized.device)
        return spatial_sum(weight * Spin_Spin_Normalized.real, L) / L.sites
