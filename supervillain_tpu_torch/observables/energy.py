"""Internal energy observables (counterpart of :mod:`supervillain_tpu.observables.energy`)."""

import torch

from .core import Observable, DerivedQuantity, Scalar


def _links_squared(S, Links):
    return torch.sum(Links ** 2, dim=tuple(range(-(S.Lattice.D + 1), 0)))


class InternalEnergyDensity(Scalar, Observable):
    r"""``U/Λ = ⟨∂_κ S⟩/Λ`` with Λ the number of sites."""

    @staticmethod
    def Villain(S, phi, n):
        return S(phi, n) / (S.Lattice.sites * S.kappa)

    @staticmethod
    def Worldline(S, Links):
        L = S.Lattice
        return (L.links / 2 - 0.5 / S.kappa * _links_squared(S, Links)) / (L.sites * S.kappa)


class InternalEnergyDensitySquared(Scalar, Observable):
    r"""``⟨U²⟩/Λ²`` including the ``-∂²_κ S`` term in the Worldline case."""

    @staticmethod
    def Villain(S, phi, n):
        return (S(phi, n) / (S.Lattice.sites * S.kappa)) ** 2

    @staticmethod
    def Worldline(S, Links):
        L = S.Lattice
        links_sq = _links_squared(S, Links)
        partial_kappa_S = (L.links / 2 - 0.5 / S.kappa * links_sq) / S.kappa
        partial_2_kappa_S = (links_sq / S.kappa - L.links / 2) / S.kappa ** 2
        return (partial_kappa_S ** 2 - partial_2_kappa_S) / L.sites ** 2


class InternalEnergyDensityVariance(DerivedQuantity):
    r"""``⟨U²/Λ²⟩ - ⟨U/Λ⟩²``."""

    @staticmethod
    def default(S, InternalEnergyDensitySquared, InternalEnergyDensity):
        return InternalEnergyDensitySquared - InternalEnergyDensity ** 2


class SpecificHeatCapacity(DerivedQuantity):
    r"""``c = κ²Λ × InternalEnergyDensityVariance``."""

    @staticmethod
    def default(S, InternalEnergyDensityVariance):
        return InternalEnergyDensityVariance * S.Lattice.sites * S.kappa ** 2
