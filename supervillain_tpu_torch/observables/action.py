"""Action-density observables (counterpart of :mod:`supervillain_tpu.observables.action`)."""

import torch

from .core import Observable, DerivedQuantity, Scalar, per_draw


def _spatial_mean(x, lattice):
    return torch.mean(x, dim=tuple(range(-lattice.D, 0)))


class ActionDensity(Scalar, Observable):
    r"""``⟨κ ∂_κ S⟩/Λ``; in the Villain case this is the action itself per site.

    In the Worldline case it is ``(|ℓ|/2 - (1/2κ)Σ Links²)/Λ``, which in D=2
    equals 1 minus the inline ``ActionDensity`` column of the fused Worldline
    kernels, ``(1/2κ)Σ(m - δv/W)²/Λ``: the kernels keep the reference kernels'
    value under that name, and an ensemble that carries the inline column
    returns it instead of measuring this one."""

    @staticmethod
    def Villain(S, phi, n):
        return S(phi, n) / S.Lattice.sites

    @staticmethod
    def Worldline(S, Links):
        L = S.Lattice
        squares = torch.sum(Links ** 2, dim=tuple(range(-(L.D + 1), 0)))
        return (L.links / 2 - 0.5 / S.kappa * squares) / L.sites


class ActionTwoPoint(Observable):
    r"""Translation-averaged ``S²_{x, x-Δx}`` via the Fourier-accelerated
    correlation, with the contact term subtracted at the origin."""

    @staticmethod
    def Villain(S, Links):
        L = S.Lattice
        density = 0.5 * S.kappa * torch.sum(Links ** 2, dim=-(L.D + 1))
        result = L.correlation(density, density).real.clone()
        result[(Ellipsis,) + L.origin] -= _spatial_mean(density, L)
        return result

    @staticmethod
    def Worldline(S, Links):
        L = S.Lattice
        m_squared = torch.sum(Links ** 2, dim=-(L.D + 1))
        derivative = 1 - 0.5 / S.kappa * m_squared
        result = L.correlation(derivative, derivative).real.clone()
        # Contact adjustment: what remains after cancelling the local
        # one-derivative term against the two-derivative term.
        result[(Ellipsis,) + L.origin] -= _spatial_mean(m_squared / 2 / S.kappa, L)
        return result


class Action_Action(DerivedQuantity):
    r"""Connected action-density correlator:
    ``ActionTwoPoint_Δx - ⟨ActionDensity⟩²``."""

    @staticmethod
    def default(S, ActionTwoPoint, ActionDensity):
        return ActionTwoPoint - per_draw(ActionDensity, S.Lattice) ** 2
