"""Gauge-invariant link variables (counterpart of
:mod:`supervillain_tpu.observables.links`)."""

from .core import Observable


class Links(Observable):
    r"""The gauge-invariant link combination each formulation's observables
    consume.  Villain: ``dφ - 2πn``; Worldline: ``m - δv/W``."""

    @staticmethod
    def Villain(S, phi, n):
        return S.links(phi, n)

    @staticmethod
    def Worldline(S, m, v):
        return S.links(m, v)
