"""Chord-model fits of the critical vortex-correlator exponent η_V.

A copy, for the port, of the fits of ``tools/w3_eta_fit.py`` (NumPy only),
which ``examples/plot/w3-analysis.py`` reads: at κ_c the vortex two-point
function falls as a pure power, G_V(r) ~ r^{-η_V}, and on the N × N torus it
follows the chord-distance form A·[c(Δx₀)² + c(Δx₁)²]^{-η/2}, c(d) =
(N/π)·sin(πd/N).  :func:`eta_fit` fits per-chain worm-visit histograms,
:func:`eta_fit_profile` their orbit-pooled profiles (:func:`orbit_profile`),
each scanning η with the amplitude solved per η, and bootstrapping over
chains for the error.
"""

from __future__ import annotations

import numpy as np


def chord_power(N, eta):
    """A=1 chord-distance power law on the N×N torus (origin set to 0)."""
    d = np.arange(N, dtype=np.float64)
    c = (N / np.pi) * np.sin(np.pi * d / N)
    r2 = c[:, None] ** 2 + c[None, :] ** 2
    r2[0, 0] = np.inf
    return r2 ** (-eta / 2)


def eta_fit(hist, r_min=2.0, etas=None, draws=200, seed=7):
    """hist: (B, N, N) per-chain worm-visit tallies.  Returns (eta, err).

    Scans χ²(η) = Σ w (G − A(η) M_η)² with w = 1/max(G,1)² (relative errors,
    Poisson-like) over ``etas`` (default 0.05..1.50 step 0.01), interpolating
    the minimum parabolically; M_η the chord-distance power law.
    """
    B, N, _ = hist.shape
    if etas is None:
        etas = np.arange(0.05, 1.51, 0.01)
    etas = np.asarray(etas)
    d = np.arange(N, dtype=np.float64)
    c = (N / np.pi) * np.sin(np.pi * d / N)
    r2 = c[:, None] ** 2 + c[None, :] ** 2
    dm = np.minimum(d, N - d)
    rr = np.sqrt(dm[:, None] ** 2 + dm[None, :] ** 2)
    sel = rr >= r_min
    logr2 = np.log(r2[sel])
    models = np.exp(np.outer(-etas / 2, logr2))

    def fit(h):
        g = h[sel]
        w = 1.0 / np.maximum(g, 1.0) ** 2
        # Per-η analytic amplitude: A = Σ w g M / Σ w M².
        wgM = models @ (w * g)
        wMM = np.einsum('ij,ij->i', models, models * w)
        A = wgM / wMM
        chi2 = (w * g * g).sum() - A * wgM
        i = int(np.argmin(chi2))
        if 0 < i < len(etas) - 1:
            y0, y1, y2 = chi2[i - 1], chi2[i], chi2[i + 1]
            denom = (y0 - 2 * y1 + y2)
            off = 0.5 * (y0 - y2) / denom if denom > 0 else 0.0
            return etas[i] + off * (etas[1] - etas[0])
        return etas[i]

    rng = np.random.default_rng(seed)
    center = fit(hist.sum(axis=0))
    samples = []
    for _ in range(draws):
        pick = rng.integers(0, B, B)
        samples.append(fit(hist[pick].sum(axis=0)))
    return float(center), float(np.std(samples))


def orbit_profile(hist):
    """Pool (B, N, N) tallies over the dihedral orbits of the torus.

    The chord model [c(dx)² + c(dy)²]^{-η/2} is exactly invariant under
    dx → N−dx, dy → N−dy, and dx ↔ dy, so cells of one orbit share a model
    value AND a flat-torus distance — pooling them is a lossless compression
    for the fit (a ~N²/8 profile instead of the N² map; the committable
    artifact for large volumes).

    Returns (r2, mult, rr, prof): per-orbit chord distance², multiplicity,
    flat-torus distance, and (B, K) pooled tallies, the origin orbit dropped.
    """
    B, N, _ = hist.shape
    d = np.arange(N)
    dm = np.minimum(d, N - d)
    a, b = np.meshgrid(dm, dm, indexing='ij')
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    label = (lo * N + hi).ravel()
    uniq, inverse, mult = np.unique(label, return_inverse=True,
                                    return_counts=True)
    c = (N / np.pi) * np.sin(np.pi * d / N)
    r2cell = (c[:, None] ** 2 + c[None, :] ** 2).ravel()
    rrcell = np.sqrt(a ** 2 + b ** 2).ravel()
    K = len(uniq)
    # Orbit-constant quantities: any representative cell serves.
    first = np.zeros(K, dtype=int)
    first[inverse[::-1]] = np.arange(N * N - 1, -1, -1)
    r2, rr = r2cell[first], rrcell[first]
    prof = np.stack([np.bincount(inverse, weights=h.ravel(), minlength=K)
                     for h in hist.reshape(B, -1)])
    keep = uniq != 0                     # drop the origin orbit
    return r2[keep], mult[keep], rr[keep], prof[:, keep]


def eta_fit_profile(r2, mult, rr, prof, r_min=2.0, etas=None, draws=200,
                    seed=7):
    """Chord-model fit from an orbit-pooled profile (see orbit_profile).

    Statistically matched to :func:`eta_fit`: per-orbit mean tallies ḡ = G/m
    carry the cell-level relative weight 1/max(ḡ,1)² times the multiplicity m,
    which is exactly the cell-level χ² when cells of an orbit hold equal
    tallies (they do in expectation — the model is orbit-constant).
    """
    if etas is None:
        etas = np.arange(0.05, 1.51, 0.01)
    etas = np.asarray(etas)
    sel = np.asarray(rr) >= r_min
    r2s, ms = np.asarray(r2, float)[sel], np.asarray(mult, float)[sel]
    models = np.exp(np.outer(-etas / 2, np.log(r2s)))
    B = prof.shape[0]

    def fit(G):
        g = G[sel] / ms
        w = ms / np.maximum(g, 1.0) ** 2
        wgM = models @ (w * g)
        wMM = np.einsum('ij,ij->i', models, models * w)
        A = wgM / wMM
        chi2 = (w * g * g).sum() - A * wgM
        i = int(np.argmin(chi2))
        if 0 < i < len(etas) - 1:
            y0, y1, y2 = chi2[i - 1], chi2[i], chi2[i + 1]
            denom = (y0 - 2 * y1 + y2)
            off = 0.5 * (y0 - y2) / denom if denom > 0 else 0.0
            return etas[i] + off * (etas[1] - etas[0])
        return etas[i]

    rng = np.random.default_rng(seed)
    center = fit(prof.sum(axis=0))
    samples = []
    for _ in range(draws):
        pick = rng.integers(0, B, B)
        samples.append(fit(prof[pick].sum(axis=0)))
    return float(center), float(np.std(samples))
