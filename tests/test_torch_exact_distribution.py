"""The port's ``sample_fleet`` on the CPU against the exact N=2 distributions.

Every case of ``tests/test_exact_distribution.py``, at its size, seed, cut and
χ²/dof < 3.5, run through the port's generators with ``device='cpu'``: on a
2×2 lattice the Boltzmann weights are enumerable, so the sampled chains are
χ²-tested against them.  The enumerations are the JAX test module's."""

import numpy as np
import pytest
import torch

import supervillain_tpu as jsv
import supervillain_tpu_torch as tsv
from supervillain_tpu_torch.generators import villain as tv, worldline as tw
from supervillain_tpu_torch.ops import calculus as tcalc
from test_exact_distribution import (KAPPA, VKAPPA, _chi2_against, _enumerate_closed_forms,
                                     _enumerate_villain_closed_n, _enumerate_villain_exact_n,
                                     _enumerate_villain_n)

CUT = 20
JL = jsv.Lattice2D(2)


def _counts(samples, known=None, overflow=2):
    counts = {}
    for x in samples.astype(np.int8):
        k = x.tobytes() if np.abs(x).max() <= overflow else b'overflow'
        if known is not None:
            assert k == b'overflow' or k in known, 'sampled a state outside the sector'
        counts[k] = counts.get(k, 0) + 1
    return counts


def _assert_chi2(prob_of, counts, n_draws):
    chi2, dof = _chi2_against(prob_of, counts, n_draws)
    assert dof >= 5, f'too few populated bins ({dof})'
    assert chi2 / dof < 3.5, f'chi2/dof = {chi2 / dof:.2f} over {dof} bins'


def _worldline_u(fleet):
    """u = m − δv (exact integers at W=1) of every kept draw after the cut."""
    L = tsv.Lattice2D(2)
    m = torch.as_tensor(fleet.columns['m'][CUT:].reshape(-1, 2, 2, 2))
    v = torch.as_tensor(fleet.columns['v'][CUT:].reshape(-1, 1, 2, 2))
    u = torch.round(m - tcalc.delta(L, 2, v.double())).numpy()
    assert np.abs(u).max() <= 3, 'sampled state outside the enumeration cutoff'
    return u


@pytest.mark.parametrize('cap', [None, 6])
def test_worldline_hammer_samples_exact_distribution(cap):
    """The Worldline Hammer at W=1, κ=0.4, unbounded (``bound_worms='off'``)
    and with a tightly capped worm (frequent truncation and rollback)."""
    S = tsv.Worldline(tsv.Lattice2D(2), KAPPA, W=1)
    forms, weights = _enumerate_closed_forms(JL, cutoff=3)
    prob_of = dict(zip((f.tobytes() for f in forms.astype(np.int8)), weights / weights.sum()))
    fleet = tsv.sample_fleet(S, tw.Hammer(S, max_worm_moves=cap), chains=48, steps=120,
                             thin=4, seed=7 if cap is None else 17, bound_worms='off',
                             device='cpu')
    u = _worldline_u(fleet)
    _assert_chi2(prob_of, _counts(u, prob_of, overflow=3), len(u))


@pytest.mark.parametrize('worm', ['classic', 'chunked'])
def test_villain_worm_samples_exact_distribution(worm):
    """The worm alone (φ frozen) at W=1: B2's plain twin and the ChunkedWorm."""
    S = tsv.Villain(tsv.Lattice2D(2), VKAPPA, W=1)
    G = tv.ClassicWorm(S) if worm == 'classic' else tv.ChunkedWorm(S, moves_per_step=12)
    forms, weights = _enumerate_villain_n(JL, cutoff=2)
    prob_of = dict(zip((f.tobytes() for f in forms.astype(np.int8)), weights / weights.sum()))
    prob_of[b'overflow'] = 16 * np.exp(-(VKAPPA / 2) * (2 * np.pi * 3) ** 2)
    fleet = tsv.sample_fleet(S, G, chains=64, steps=100, thin=4, seed=11, bound_worms='off',
                             device='cpu')
    ns = fleet.columns['n'][CUT:].reshape(-1, 2, 2, 2)
    assert np.abs(ns).max() <= 3, 'sampled n far outside the enumeration cutoff'
    _assert_chi2(prob_of, _counts(ns), len(ns))


@pytest.mark.parametrize('cap,thin', [(None, 4), (8, 16)])
def test_villain_worm_w2_exact_distribution(cap, thin):
    """The W=2 worm alone over the closed (dn = 0) forms, unbounded and capped
    at 8 moves (truncated worms roll back)."""
    S = tsv.Villain(tsv.Lattice2D(2), VKAPPA, W=2)
    forms, weights = _enumerate_villain_closed_n(JL, cutoff=2)
    prob_of = dict(zip((f.tobytes() for f in forms.astype(np.int8)), weights / weights.sum()))
    fleet = tsv.sample_fleet(S, tv.ClassicWorm(S, max_moves=cap), chains=64, steps=100,
                             thin=thin, seed=13, bound_worms='off', device='cpu')
    ns = fleet.columns['n'][CUT:].reshape(-1, 2, 2, 2)
    counts = _counts(ns, prob_of)
    prob_of[b'overflow'] = 4 * np.exp(-(VKAPPA / 2) * 2 * (2 * np.pi * 3) ** 2)
    _assert_chi2(prob_of, counts, len(ns))


def test_exact_neighborhood_samples_exact_distribution():
    """The z-only ExactNeighborhoodUpdate (interval_phi = 0) at W=∞ over the
    exact forms n = dz: B1's plain twin in z-mode."""
    S = tsv.Villain(tsv.Lattice2D(2), VKAPPA, W=float('inf'))
    G = tv.ExactNeighborhoodUpdate(S, interval_phi=0.0, interval_z=1)
    forms = _enumerate_villain_exact_n(JL, zcut=3)
    Z = sum(forms.values())
    prob_of = {k: w / Z for k, w in forms.items()}
    fleet = tsv.sample_fleet(S, G, chains=64, steps=100, thin=4, seed=23, device='cpu')
    ns = fleet.columns['n'][CUT:].reshape(-1, 2, 2, 2)
    counts = {}
    for x in ns.astype(np.int8):
        assert x.tobytes() in prob_of, 'sampled n is not an exact form (dz)'
        counts[x.tobytes()] = counts.get(x.tobytes(), 0) + 1
    _assert_chi2(prob_of, counts, len(ns))
