"""Action density (counterpart of :mod:`supervillain_tpu.observables.action`)."""

import torch

from .core import Observable, Scalar


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
