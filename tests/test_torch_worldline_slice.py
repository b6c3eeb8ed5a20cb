"""The port's Worldline path end to end on the CPU: ``sample_fused_fleet`` with
worms (the fused Worldline Hammer, plain path) against the JAX package's
``FusedWorldlineHammer`` under ``Ensemble.generate`` (its XLA fallback); the
entry points' default device; and the port's independence from JAX."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import supervillain_tpu as jsv
from supervillain_tpu.generators import FusedWorldlineHammer as JaxFusedWorldlineHammer
import supervillain_tpu_torch as tsv
from supervillain_tpu_torch.interop import state_from_numpy, worldline_state_from_numpy
from supervillain_tpu_torch.ops.worldline import worldline_sweeps
from supervillain_tpu_torch.ops.worldline_hammer import worldline_hammer_sweeps
from supervillain_tpu_torch.ops.worldline_worm import worldline_worms

N, KAPPA, W, THIN = 8, 0.5, 2, 2
STEPS, CUT = 80, 20
REPO = pathlib.Path(__file__).resolve().parents[1]


def _estimate(module, action, columns):
    # The port measures on the card unless told otherwise; these tests run on the CPU.
    where = {'device': 'cpu'} if module is tsv else {}
    e = module.Ensemble(action).from_configurations(module.Configurations(columns), **where)
    boot = module.Bootstrap(e, draws=200, seed=0)
    return {k: boot.estimate(k) for k in columns}


def test_fused_fleet_agrees_with_jax_fused_worldline_hammer():
    """Both samplers run the same transition kernel from a cold start, so the
    per-chain means over records CUT..STEPS must agree within 5 combined σ:
    Worm_Length, and the port's inline ActionDensity, (1/2κ)Σu²/Λ, against 1
    minus the ActionDensity the JAX package measures on its CPU fallback's
    fields (the registry observable of that name)."""
    port = tsv.sample_fused_fleet(tsv.Worldline(tsv.Lattice2D(N), KAPPA, W=W), chains=16,
                                  steps=STEPS, thin=THIN, worms=1, seed=1, device='cpu')
    assert port.columns['Spin_Spin'].shape == (STEPS, 16, N, N)
    assert set(port.final) == {'m', 'v'} and port.final['v'].dtype == np.int64
    assert not port.columns['Worm_Truncated'].any()
    np.testing.assert_array_equal(port.columns['Worm_Length'],
                                  port.columns['Spin_Spin'].sum(axis=(2, 3)))
    ours = _estimate(tsv, port.Action, {
        k: port.columns[k][CUT:].mean(axis=0) for k in ('ActionDensity', 'Worm_Length')})

    S = jsv.Worldline(jsv.Lattice2D(N), KAPPA, W=W)
    G = JaxFusedWorldlineHammer(S, sweeps_per_step=THIN, worms=1)
    runs = [jsv.Ensemble(S).generate(STEPS, G, seed=seed).cut(CUT) for seed in range(6)]
    ref = _estimate(jsv, S, {
        'ActionDensity': np.array([1 - np.asarray(e.ActionDensity).mean() for e in runs]),
        'Worm_Length': np.array([np.asarray(e.Worm_Length).mean() for e in runs])})

    for k in ours:
        (m1, e1), (m2, e2) = ours[k], ref[k]
        assert abs(m1 - m2) < 5 * np.hypot(e1, e2), (k, ours[k], ref[k])


def test_ensemble_generate_fused_worldline_hammer_on_cpu():
    """The README quick start on the CPU: inline ActionDensity is the kernels'
    value, so the ensemble returns it instead of measuring the registry
    observable (1 minus it in D=2)."""
    S = tsv.Worldline(tsv.Lattice2D(6), 0.5, W=float('inf'))
    G = tsv.FusedWorldlineHammer(S, sweeps_per_step=2, interval_v=0.5)
    e = tsv.Ensemble(S).generate(6, G, seed=2, device='cpu')
    assert e.m.shape == (6, 2, 6, 6) and e.v.dtype == np.float64
    assert all(S.valid({'m': torch.as_tensor(m)}) for m in e.m)
    assert np.abs(e.v).max() > 0
    assert e.stats['WorldlineLocalUpdates']['proposed'] == 6 * 2 * (2 * 36 + 12)
    assert e.stats['ClassicWorm']['sweeps'] == 6
    np.testing.assert_array_equal(e.Worm_Length, e.Spin_Spin.sum(axis=(1, 2)))
    assert e.ActionDensity.shape == (6,) and np.isfinite(e.ActionDensity).all()
    assert 'WorldlineLocalUpdates' in G.report(e.stats)


def test_cpu_run_never_reports_a_kernel_launch(monkeypatch):
    """With a GPU reported present, CPU tensors still take the plain path."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    counters = (worldline_sweeps, worldline_worms, worldline_hammer_sweeps)
    before = [f.launches for f in counters]
    S = tsv.Worldline(tsv.Lattice2D(4), 0.5, W=2)
    for worms in (0, 1):
        fleet = tsv.sample_fused_fleet(S, chains=3, steps=2, thin=2, worms=worms,
                                       max_worm_moves=4, keep_fields=True, device='cpu')
        assert all(S.valid({'m': torch.as_tensor(m)}) for m in fleet.final['m'])
        assert fleet.columns['m'].shape == (2, 3, 2, 4, 4)
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize('call', ['fleet', 'worldline_fleet', 'generate', 'villain_initial',
                                  'worldline_initial', 'state', 'worldline_state'])
def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch, call):
    """With no card, an entry point called without a device raises (naming the
    CPU way out) instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    V = tsv.Villain(tsv.Lattice2D(4), 0.5, W=1)
    S = tsv.Worldline(tsv.Lattice2D(4), 0.5, W=1)
    calls = {
        'fleet': lambda: tsv.sample_fused_fleet(V, chains=2, steps=1),
        'worldline_fleet': lambda: tsv.sample_fused_fleet(S, chains=2, steps=1, worms=1),
        'generate': lambda: tsv.Ensemble(S).generate(1, tsv.FusedWorldlineHammer(S)),
        'villain_initial': lambda: V.initial(),
        'worldline_initial': lambda: S.initial(),
        'state': lambda: state_from_numpy({'phi': np.zeros((1, 4, 4)), 'n': np.zeros((2, 4, 4))}),
        'worldline_state': lambda: worldline_state_from_numpy(
            {'m': np.zeros((2, 4, 4)), 'v': np.zeros((1, 4, 4))}, 1),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[call]()


def test_port_and_chip_smoke_import_nothing_of_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the JAX package."""
    files = sorted((REPO / 'supervillain_tpu_torch').rglob('*.py')) + [REPO / 'chip_smoke.py']
    assert len(files) > 20
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            bad += [f'{path.relative_to(REPO)}: {n}' for n in names
                    if n.split('.')[0] in ('jax', 'jaxlib', 'supervillain_tpu')]
    assert not bad, bad
