"""Topological-charge observables of the D=4 Villain model (counterpart of
:mod:`supervillain_tpu.observables.topological`), measured through
:func:`..ops.calculus.wedge` on the ensemble's device."""

import torch

from ..device import float_dtype_of
from ..ops import calculus as calc
from .core import Observable, Scalar, DerivedQuantity


def _charge_density(S, n):
    """The local charge density q = dn ∧ dn, a 4-form (D=4 only), per draw."""
    L = S.Lattice
    if L.D != 4:
        raise NotImplementedError('Topological-charge observables require D = 4.')
    field_strength = calc.d(L, 1, n)
    return calc.wedge(L, 2, field_strength, 2, field_strength)


def _spatial(S):
    return tuple(range(-S.Lattice.D, 0))


class TopologicalChargeDensity(Observable):
    r"""``q_x = (dn ∧ dn)_x``: one value per 4-cell.  Exact, so its lattice sum
    (the total charge) vanishes configuration by configuration on the torus."""

    @staticmethod
    def Villain(S, n):
        return _charge_density(S, n).sum(dim=-(S.Lattice.D + 1))


class TopologicalCharge(Scalar, Observable):
    r"""``Q = Σ_x q_x``, identically zero on the periodic lattice."""

    @classmethod
    def autocorrelation(cls, ensemble):
        # Identically zero: no fluctuations to autocorrelate.
        return False

    @staticmethod
    def Villain(S, TopologicalChargeDensity):
        return TopologicalChargeDensity.sum(dim=_spatial(S))


class TopologicalChargeDensitySquared(Scalar, Observable):
    r"""``(1/Λ) Σ_x q_x²``: the local topological fluctuation."""

    @classmethod
    def autocorrelation(cls, ensemble):
        from ..models import Villain
        S = ensemble.Action
        return (isinstance(S, Villain) and S.Lattice.D == 4 and S.W < float('inf')
                and super().autocorrelation(ensemble))

    @staticmethod
    def Villain(S, TopologicalChargeDensity):
        q = TopologicalChargeDensity.to(float_dtype_of(TopologicalChargeDensity))
        return torch.mean(q ** 2, dim=_spatial(S))


class TopologicalTwoPoint(Observable):
    r"""``(1/Λ) Σ_x q_x q_{x−Δx}`` via the Fourier-accelerated correlation."""

    @staticmethod
    def Villain(S, TopologicalChargeDensity):
        q = TopologicalChargeDensity.to(float_dtype_of(TopologicalChargeDensity))
        return S.Lattice.correlation(q, q).real


class Topological_Topological(DerivedQuantity):
    r"""Connected charge correlator:
    ``TopologicalTwoPoint − correlation(⟨q⟩, ⟨q⟩)``."""

    @staticmethod
    def default(S, TopologicalTwoPoint, TopologicalChargeDensity):
        q = TopologicalChargeDensity
        return TopologicalTwoPoint - S.Lattice.correlation(q, q).real
