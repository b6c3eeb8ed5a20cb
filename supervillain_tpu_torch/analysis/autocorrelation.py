"""FFT-accelerated autocorrelation: a NumPy copy of
:mod:`supervillain_tpu.analysis.autocorrelation`."""

from __future__ import annotations

import numpy as np


def autocorrelation(data, mean=None, _cutoff=1e-16):
    r"""Normalized autocorrelation function ``C(τ)`` (periodic approximation, Fourier
    accelerated) and the ceiling of the integrated autocorrelation time
    ``τ_int = Σ_{τ<τ_0} C(τ)`` up to the first non-positive value.

    Raises ValueError when the series does not fluctuate (``C(0)`` below cutoff).
    """
    data = np.asarray(data)
    if mean is None:
        mean = data.mean()
    Delta = data - mean

    plus = np.fft.fft(Delta, norm='backward')
    minus = np.fft.ifft(Delta, norm='forward')
    C = np.fft.fft(plus * minus, norm='backward').real / len(Delta) ** 2
    if np.abs(C[0]) < _cutoff:
        raise ValueError('The fluctuations are too small to reliably determine an autocorrelation.')
    C = C / C[0]

    # Integrate C(τ) to (excluding) the first non-positive value; when C stays
    # positive throughout, integrate the whole series (the conservative,
    # larger-τ choice).
    nonpositive = np.nonzero(C <= 0)[0]
    cut = int(nonpositive[0]) if nonpositive.size else len(C)
    return C, int(np.ceil(C[:cut].sum()))


def autocorrelation_time(data, mean=None):
    r"""Just ``τ_int`` from :func:`autocorrelation`."""
    _, tau = autocorrelation(data, mean)
    return tau
