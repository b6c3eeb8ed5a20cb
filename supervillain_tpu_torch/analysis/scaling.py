"""Finite-size-scaling helpers for the generalized-BKT analysis: a NumPy copy
of :mod:`supervillain_tpu.analysis.scaling`.

The generalized BKT transitions have critical scaling dimensions
Δ_spin = W²/8 and Δ_vortex = 2/W²; these are the standard finite-size
manipulations of the susceptibilities scaled by them.
"""

from __future__ import annotations

import numpy as np


def scaled_susceptibility(chi, L, Delta, D=2):
    """χ / L^(D−2Δ): size-independent at the critical coupling (up to the BKT
    logarithmic corrections), decreasing with L in the disordered phase,
    increasing with L inside the critical phase (where η(κ) < 2Δ).

    >>> float(scaled_susceptibility(64.0, 256, Delta=0.5))   # W=2: χ/L
    0.25
    >>> float(scaled_susceptibility(32.0, 64, Delta=0.125))  # W=1: χ/L^1.75
    0.0220970869...
    """
    return np.asarray(chi) / L ** (D - 2 * Delta)


def effective_exponent(L1, chi1, L2, chi2):
    """The two-volume effective correlator power: χ ~ L^(2−η_eff) gives

        2 − η_eff = ln(χ₂/χ₁) / ln(L₂/L₁)

    Returns (two_minus_eta, eta_eff).  At a BKT transition η_eff → 2Δ from
    below as L → ∞ (with slow log corrections); deep in the critical phase
    η_eff ≈ 1/(2πκ_R).

    >>> effective_exponent(128, 100.0, 256, 100.0 * 2 ** 1.75)
    (1.75, 0.25)
    """
    two_minus_eta = float(np.log(chi2 / chi1) / np.log(L2 / L1))
    return two_minus_eta, 2.0 - two_minus_eta


def effective_exponent_error(L1, chi1, e1, L2, chi2, e2):
    """Propagated 1σ error of η_eff from independent χ errors.

    >>> round(effective_exponent_error(128, 100.0, 1.0, 256, 175.0, 2.0), 4)
    0.0219
    """
    rel = np.hypot(e1 / chi1, e2 / chi2)
    return float(rel / abs(np.log(L2 / L1)))


def crossing_estimate_error(kappas, scaled_by_L, errors_by_L, *, draws=1000,
                            seed=0, pair=None):
    """κ_c with a propagated 1σ error from the pairwise scaling crossing.

    Gaussian-resamples every scaled-susceptibility point within its quoted
    error, recomputes :func:`crossing_estimate` per draw, and reports the
    sample mean/std over the draws that *do* cross inside the window.

    Parameters
    ----------
    kappas : sequence of couplings (common grid for every volume).
    scaled_by_L : {L: array over kappas} of χ/L^(D−2Δ) central values.
    errors_by_L : {L: array over kappas} of their 1σ errors.
    draws : resampling draws.
    seed : numpy Generator seed (fixed default: analyses are reproducible).
    pair : optional (L_small, L_large) selecting which two volumes cross;
        default the two largest (the pair with the least finite-size drift).

    Returns
    -------
    (kappa_c, error, crossed_fraction) — ``kappa_c`` is None when fewer than
    half the draws cross inside the scanned window (the estimate would then
    say more about the window than the data).

    >>> kappas = [0.07, 0.08, 0.09]
    >>> scaled = {128: np.array([1.2, 0.9, 0.6]), 256: np.array([1.5, 0.9, 0.4])}
    >>> errs = {128: np.full(3, 0.02), 256: np.full(3, 0.02)}
    >>> k, e, frac = crossing_estimate_error(kappas, scaled, errs)
    >>> 0.078 < k < 0.082 and e < 0.002 and frac == 1.0
    True
    """
    Ls = sorted(scaled_by_L)
    if pair is None:
        pair = (Ls[-2], Ls[-1])
    rng = np.random.default_rng(seed)
    sub = {L: np.asarray(scaled_by_L[L], dtype=float) for L in pair}
    esub = {L: np.asarray(errors_by_L[L], dtype=float) for L in pair}
    samples = []
    for _ in range(draws):
        jittered = {L: sub[L] + esub[L] * rng.standard_normal(len(kappas))
                    for L in pair}
        k = crossing_estimate(kappas, jittered)
        if k is not None:
            samples.append(k)
    frac = len(samples) / draws
    if frac < 0.5:
        return None, None, frac
    return float(np.mean(samples)), float(np.std(samples)), frac


def crossing_estimate(kappas, scaled_by_L):
    """Crude critical-coupling estimate: the κ where the scaled susceptibility
    of the two largest volumes crosses (linear interpolation of their
    difference).  ``scaled_by_L``: {L: array over kappas}.  Returns None when
    the curves do not cross inside the scanned window."""
    Ls = sorted(scaled_by_L)
    a = np.asarray(scaled_by_L[Ls[-2]], dtype=float)
    b = np.asarray(scaled_by_L[Ls[-1]], dtype=float)
    diff = b - a
    sign = np.sign(diff)
    for i in range(len(kappas) - 1):
        if sign[i] != sign[i + 1] and sign[i] != 0:
            k0, k1 = kappas[i], kappas[i + 1]
            d0, d1 = diff[i], diff[i + 1]
            return float(k0 + (k1 - k0) * (-d0) / (d1 - d0))
    return None
