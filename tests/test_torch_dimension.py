"""General D on the port's CPU path, after ``tests/test_dimension_sweep.py``:
both Hammers at D ∈ {3, 4} × W ∈ {1, 2, ∞}, N=3 (odd N: 2^D colours), keep
their constraints, the action's gauge and equivalence invariance and finite
observables; ⟨ActionDensity⟩ at D=3 agrees with a JAX run within Monte-Carlo
error; the fused generators fall back to the eager updates at D ≥ 3 (no inline
column, no kernel path) and the worms refuse D ≠ 2 as the JAX ones do; and the
ported ``d4-topology.py`` and ``benchmark/`` harnesses run on the CPU."""

import pathlib
import runpy
import sys
from functools import cache

import numpy as np
import pytest
import torch

import supervillain_tpu as jsv
import supervillain_tpu_torch as tsv
from supervillain_tpu.generators import villain as jv, worldline as jw
from supervillain_tpu.parallel import sample_fleet as jax_sample_fleet
from supervillain_tpu_torch.generators import villain as tv, worldline as tw
from supervillain_tpu_torch.ops import calculus as tcalc
from supervillain_tpu_torch.ops import sweep as tsweep, worldline_worm as tworm

DS = (3, 4)
WS = (1, 2, float('inf'))
STEPS = 8
N = 3
PULL_BOUND = 4.0
EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / 'supervillain_tpu_torch' / 'examples'


@cache
def villain_ensemble(D, W):
    S = tsv.Villain(tsv.Lattice(D, N), 0.5, W)
    return S, tsv.Ensemble(S).generate(STEPS, tv.Hammer(S), seed=D * 101 + 7, device='cpu')


@cache
def worldline_ensemble(D, W):
    S = tsv.Worldline(tsv.Lattice(D, N), 0.5, W)
    return S, tsv.Ensemble(S).generate(STEPS, tw.Hammer(S), seed=D * 211 + 3, device='cpu')


def _field(e, name, i):
    return torch.as_tensor(np.asarray(getattr(e, name))[i])


@pytest.mark.parametrize('D', DS)
@pytest.mark.parametrize('W', WS)
def test_villain_hammer_keeps_the_constraint_and_gauge_invariance(D, W):
    S, e = villain_ensemble(D, W)
    for i in range(0, STEPS, 3):
        assert S.valid({'n': _field(e, 'n', i)})
    k = torch.as_tensor(np.random.default_rng(D).integers(-2, 3, (1,) + S.Lattice.dims))
    cfg = {'phi': _field(e, 'phi', -1), 'n': _field(e, 'n', -1)}
    moved = S.gauge_transform(cfg, k)
    s0, s1 = float(S(cfg['phi'], cfg['n'])), float(S(moved['phi'], moved['n']))
    assert abs(s1 - s0) < 1e-9 * max(1.0, abs(s0))
    assert not torch.equal(moved['n'], cfg['n'])


@pytest.mark.parametrize('D', DS)
@pytest.mark.parametrize('W', WS)
def test_worldline_hammer_keeps_the_constraint_and_equivalence_invariance(D, W):
    S, e = worldline_ensemble(D, W)
    for i in range(0, STEPS, 3):
        assert S.valid({'m': _field(e, 'm', i)})
    cfg = {'m': _field(e, 'm', -1), 'v': _field(e, 'v', -1)}
    fixed = S.equivalence_class_v(cfg)
    torch.testing.assert_close(S.links(fixed['m'], fixed['v']), S.links(cfg['m'], cfg['v']),
                               rtol=0, atol=1e-12)
    assert S.valid(fixed)


@pytest.mark.parametrize('D', DS)
@pytest.mark.parametrize('W', WS)
def test_observables_finite_in_d(D, W):
    S, e = villain_ensemble(D, W)
    for name in ('ActionDensity', 'InternalEnergyDensity', 'WindingSquared'):
        assert np.isfinite(np.asarray(getattr(e, name))).all(), name
    if W == float('inf'):
        np.testing.assert_array_equal(e.WindingSquared, 0.0)
    S, e = worldline_ensemble(D, W)
    for name in ('ActionDensity', 'InternalEnergyDensity'):
        assert np.isfinite(np.asarray(getattr(e, name))).all(), name


@pytest.mark.parametrize('W', WS)
def test_d4_topological_charge_consistency(W):
    S, e = villain_ensemble(4, W)
    q, qd = np.asarray(e.TopologicalCharge), np.asarray(e.TopologicalChargeDensity)
    np.testing.assert_array_equal(q, qd.sum(axis=tuple(range(1, qd.ndim))))
    np.testing.assert_array_equal(q, 0)
    if W == float('inf'):
        np.testing.assert_array_equal(e.TopologicalChargeDensitySquared, 0)


@pytest.mark.parametrize('D,W', [(3, 1), (3, 2), (4, 1)])
def test_worldline_local_updates_separately_in_d(D, W):
    S = tsv.Worldline(tsv.Lattice(D, N), 0.5, W)
    for G in (tw.VortexUpdate(S), tw.CoexactUpdate(S), tw.WrappingUpdate(S),
              tw.PlaquetteUpdate(S)):
        e = tsv.Ensemble(S).generate(4, G, seed=D * 31 + W, device='cpu')
        assert S.valid({'m': _field(e, 'm', -1)})
        assert float(e.stats[G.name]['accepted']) > 0


@pytest.mark.parametrize('D', DS)
def test_worldline_worm_in_d(D):
    """The worm is dimension-general: 2D moves and a 1/(2D+1) close; δm = 0 on
    every kept draw, and Spin_Spin of shape N^D summing to the worm length."""
    S = tsv.Worldline(tsv.Lattice(D, N), 0.8, W=1)
    e = tsv.Ensemble(S).generate(6, tw.ClassicWorm(S), seed=D, device='cpu')
    for i in range(6):
        assert S.valid({'m': _field(e, 'm', i)})
    hist = np.asarray(e.configuration.fields['Spin_Spin'])
    assert hist.shape == (6,) + (N,) * D
    np.testing.assert_array_equal(hist.sum(axis=tuple(range(1, D + 1))),
                                  e.configuration.fields['Worm_Length'])


def test_worldline_worm_moves_match_the_d2_rule():
    """At D=2 the general move table is the kernel's: +e0, +e1, −e0, −e1."""
    draws = tworm.WorldlineWormDraws(torch.Generator().manual_seed(0), B=2, N=4,
                                     fdt=torch.float64, device='cpu', D=3)
    assert draws.start()[1].shape == (2, 3)
    assert bool((draws.move()[1] < 6).all())
    assert tworm.close_probability(2) == tworm.CLOSE == 0.2


def _chain_means(fleet, cut):
    values = np.asarray(fleet.pooled_ensemble(cut).ActionDensity)
    return values.reshape(-1, fleet.chains).mean(axis=0)


def _pull(a, b):
    se = np.hypot(a.std(ddof=1) / np.sqrt(len(a)), b.std(ddof=1) / np.sqrt(len(b)))
    return (a.mean() - b.mean()) / se


@pytest.mark.parametrize('action', ['Villain', 'Worldline'])
def test_d3_action_density_agrees_with_jax(action):
    """The generic Hammer at D=3, N=3, κ=0.5, W=2 (the Villain one worm-free,
    the Worldline one with its general worm): per-chain ⟨ActionDensity⟩ of 32
    chains against a JAX run, within PULL_BOUND."""
    J = getattr(jsv, action)(jsv.Lattice(3, N), 0.5, W=2)
    T = getattr(tsv, action)(tsv.Lattice(3, N), 0.5, W=2)
    jg, tg = (jv, tv) if action == 'Villain' else (jw, tw)
    args = dict(chains=32, steps=30, thin=1)
    ours = tsv.sample_fleet(T, tg.Hammer(T, fleet=True), seed=8, device='cpu', **args)
    theirs = jax_sample_fleet(J, jg.Hammer(J, fleet=True), seed=9, **args)
    assert abs(_pull(_chain_means(ours, 8), _chain_means(theirs, 8))) < PULL_BOUND


def test_fused_generators_fall_back_at_d3(monkeypatch):
    """At D ≥ 3 the fused sweeps run the eager updates (no inline column) and
    never reach a kernel's wrapper; the fused worms refuse D ≠ 2."""
    def refuse(*args, **kwargs):
        raise AssertionError('a D=2 kernel wrapper was called at D=3')

    monkeypatch.setattr(tsweep, 'neighborhood_sweeps', refuse)
    monkeypatch.setattr(tv, 'neighborhood_sweeps', refuse)
    monkeypatch.setattr(tw, 'worldline_worms', refuse)
    L = tsv.Lattice(3, N)
    V, Wl = tsv.Villain(L, 0.5, W=2), tsv.Worldline(L, 0.5, W=2)
    for S, G in ((V, tsv.FusedNeighborhoodUpdate(V, sweeps_per_step=2)),
                 (tsv.Villain(L, 0.5, W=float('inf')),
                  tsv.FusedExactNeighborhoodUpdate(tsv.Villain(L, 0.5, W=float('inf')))),
                 (Wl, tsv.FusedWorldlineUpdate(Wl, sweeps_per_step=2))):
        assert G.inline_shapes() == {}
        fleet = tsv.sample_fleet(S, G, chains=3, steps=2, thin=1, seed=1, device='cpu')
        assert set(fleet.columns) == set(S.fields)
    fleet = tsv.sample_fleet(Wl, tw.Hammer(Wl, fleet=True), chains=3, steps=2, thin=1, seed=1,
                             device='cpu')
    assert S.valid({'m': torch.as_tensor(fleet.final['m'][0])})
    for make in (lambda: tsv.FusedHammer(V), lambda: tsv.FusedClassicWorm(V),
                 lambda: tv.ClassicWorm(V), lambda: tv.ChunkedWorm(tsv.Villain(L, 0.5, W=1)),
                 lambda: tsv.FusedWorldlineWorm(Wl), lambda: tsv.FusedWorldlineHammer(Wl)):
        with pytest.raises(NotImplementedError, match='D=2'):
            make()
    assert [type(g).__name__ for g in tv.Hammer(V).generators] == [
        'SiteUpdate', 'LinkUpdate', 'ExactUpdate', 'CohomologyUpdate']


def test_d3_neighborhood_sweep_matches_its_d2_form():
    """The D-general plain sweep, run on a D=2 batch with D=2 draws, is the
    same transition as before: a D=2 batch of the eager NeighborhoodUpdate
    through neighborhood_sweeps equals plain_sweeps on the same generator."""
    S = tsv.Villain(tsv.Lattice2D(5), 0.5, W=2)
    cold = S.initial('cpu')
    cfg = {k: v.expand((4,) + v.shape).contiguous() for k, v in cold.items()}
    a = tsweep.neighborhood_sweeps(cfg['phi'], cfg['n'], kappa=0.5, W=2, interval_phi=np.pi,
                                   interval_n=1, sweeps=3,
                                   generator=torch.Generator().manual_seed(4))
    draws = tsweep.SweepDraws(torch.Generator().manual_seed(4), B=4, N=5, interval_phi=np.pi,
                              interval_n=1, p_n=None, zmode=False, fdt=torch.float64,
                              idt=torch.int64, device='cpu', D=2)
    b = tsweep.plain_sweeps(cfg['phi'], cfg['n'], kappa=0.5, W=2, sweeps=3, draws=draws)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)


def _run(argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['d4-topology.py'] + [str(a) for a in argv])
    return runpy.run_path(str(EXAMPLES / 'd4-topology.py'), run_name='__main__')


def test_d4_topology_script_at_winf_on_the_cpu(monkeypatch, capsys):
    """W=∞: Q ≡ 0 and WindingSquared ≡ 0 exactly, as the JAX script asserts."""
    g = _run(['--device', 'cpu', '--W', 'inf', '--kappas', '0.4', '--steps', '4', '--cut', '1'],
             monkeypatch)
    out = capsys.readouterr().out
    assert '# D=4 Villain, 3^4, W=inf, 4 chains × 4×2 Hammer steps, device=cpu' in out
    assert 'ActionDensity' in out and '⟨Q²⟩·Λ' in out
    row = out.strip().splitlines()[-1].split()
    assert row[0] == '0.40' and row.count('+0.0') == 2     # WindingSquared and ⟨Q²⟩·Λ
    assert callable(g['main'])


def test_benchmarks_run_on_the_cpu(capsys):
    from supervillain_tpu_torch.benchmark import dimension, form_kernels
    rate, seconds = dimension.steady_state_rate(D=3, N=3, chains=4, thin=2, reps=1,
                                                device='cpu')
    assert rate > 0 and seconds > 0
    curve = dimension.saturation_curve(D=4, N=3, chain_counts=(2, 4), thin=1, reps=1,
                                       samples=1, device='cpu')
    assert set(curve) <= {'chains=2', 'chains=4'} and all(r > 0 for r in curve.values())
    rows = form_kernels.benchmark_form_kernels(Ds=(2, 4), Ns=(3,), reps=1, device='cpu')
    assert [r[2] for r in rows[:4]] == ['d', 'delta', 'face_sum', 'coface_sum']
    assert len(rows) == 8 and 'device μs' in capsys.readouterr().out
