"""Action density (counterpart of :mod:`supervillain_tpu.observables.action`)."""

from .core import Observable, Scalar


class ActionDensity(Scalar, Observable):
    r"""``⟨κ ∂_κ S⟩/Λ``; in the Villain case this is the action itself per site."""

    @staticmethod
    def Villain(S, phi, n):
        return S(phi, n) / S.Lattice.sites
