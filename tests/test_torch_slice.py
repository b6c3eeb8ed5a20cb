"""The port's main path end to end on the CPU: ``sample_fused_fleet`` with worms
(the fused Hammer, plain path) against the JAX package's ``FusedHammer`` under
``Ensemble.generate`` (its XLA fallback), then the analysis layer."""

import numpy as np
import pytest
import torch

import supervillain_tpu as jsv
from supervillain_tpu.generators import FusedHammer as JaxFusedHammer
import supervillain_tpu_torch as tsv
from supervillain_tpu_torch.ops import kernels
from supervillain_tpu_torch.ops.hammer import hammer_sweeps
from supervillain_tpu_torch.ops.sweep import neighborhood_sweeps
from supervillain_tpu_torch.ops.worm import classic_worms

N, KAPPA, THIN = 8, 0.5, 2
STEPS, CUT = 150, 50


def _estimate(module, action, columns):
    e = module.Ensemble(action).from_configurations(module.Configurations(columns))
    boot = module.Bootstrap(e, draws=200, seed=0)
    return {k: boot.estimate(k) for k in columns}


def test_fused_fleet_agrees_with_jax_fused_hammer():
    """From a cold start both samplers follow the same (slowly thermalizing)
    trajectory in expectation, so the mean over records CUT..STEPS of each
    chain must agree.  Chains are independent: the bootstrap runs over per-chain
    means, and the two must agree within 5 combined σ."""
    port = tsv.sample_fused_fleet(tsv.Villain(tsv.Lattice2D(N), KAPPA, W=1), chains=24,
                                  steps=STEPS, thin=THIN, worms=1, seed=1)
    assert port.columns['Vortex_Vortex'].shape == (STEPS, 24, N, N)
    assert not port.columns['Worm_Truncated'].any()
    pooled = port.pooled_ensemble(CUT)
    assert len(pooled) == 24 * (STEPS - CUT)
    np.testing.assert_allclose(pooled.ActionDensity.mean(),
                               port.columns['ActionDensity'][CUT:].mean(), rtol=1e-12)
    ours = _estimate(tsv, port.Action, {
        k: port.columns[k][CUT:].mean(axis=0) for k in ('ActionDensity', 'Worm_Length')})

    S = jsv.Villain(jsv.Lattice2D(N), KAPPA, W=1)
    G = JaxFusedHammer(S, sweeps_per_step=THIN, worms=1)
    runs = [jsv.Ensemble(S).generate(STEPS, G, seed=seed).cut(CUT) for seed in range(6)]
    ref = _estimate(jsv, S, {
        'ActionDensity': np.array([np.asarray(e.ActionDensity).mean() for e in runs]),
        'Worm_Length': np.array([np.asarray(e.Worm_Length).mean() for e in runs])})

    for k in ours:
        (m1, e1), (m2, e2) = ours[k], ref[k]
        assert abs(m1 - m2) < 5 * np.hypot(e1, e2), (k, ours[k], ref[k])


def test_analysis_matches_jax_exactly():
    rng = np.random.default_rng(41)
    x = np.zeros(400)
    for i in range(1, 400):
        x[i] = 0.8 * x[i - 1] + rng.normal()
    cols = {'ActionDensity': x, 'WindingSquared': x ** 2}
    S = (tsv.Villain(tsv.Lattice2D(4), 0.5), jsv.Villain(jsv.Lattice2D(4), 0.5))
    ours = tsv.Ensemble(S[0]).from_configurations(tsv.Configurations(cols))
    ref = jsv.Ensemble(S[1]).from_configurations(jsv.Configurations(cols))
    assert tsv.autocorrelation_time(x) == jsv.analysis.autocorrelation_time(x)
    assert ours.autocorrelation_time() == ref.autocorrelation_time()
    tau = ours.autocorrelation_time()
    a = tsv.Bootstrap(ours.cut(20).every(tau), draws=77, seed=5)
    b = jsv.Bootstrap(ref.cut(20).every(tau), draws=77, seed=5)
    for name in cols:
        assert a.estimate(name) == b.estimate(name)


def test_cpu_run_never_reports_a_kernel_launch(monkeypatch):
    """With a GPU reported present, CPU tensors still take the plain path: the
    dispatch is by the tensors' device, never by what the machine has."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    counters = (neighborhood_sweeps, classic_worms, hammer_sweeps)
    before = [f.launches for f in counters]
    S = tsv.Villain(tsv.Lattice2D(4), 0.5, W=2)
    fleet = tsv.sample_fused_fleet(S, chains=3, steps=2, thin=2, worms=1, max_worm_moves=4)
    assert [f.launches for f in counters] == before
    assert all(S.valid({'n': torch.as_tensor(n)}) for n in fleet.final['n'])


def test_cuda_only_paths_raise_instead_of_falling_back():
    phi = torch.zeros((2, 1, 4, 4))
    n = torch.zeros((2, 2, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match='CUDA device'):
        kernels.require_fields(phi, n)
    meta = (phi.to('meta'), n.to('meta'))
    with pytest.raises(ValueError, match='CPU or a CUDA device'):
        hammer_sweeps(*meta, kappa=0.5, W=1, interval_phi=1.0, interval_n=1, sweeps=1,
                      generator=torch.Generator())
    with pytest.raises(ValueError, match='CPU or a CUDA device'):
        classic_worms(*meta, kappa=0.5, W=1, generator=torch.Generator())


def test_ensemble_generate_fused_hammer_on_cpu():
    """The README quick start: Ensemble.generate over FusedHammer, then the
    observables (inline ActionDensity equals the average of the two sweeps'
    action densities, so it differs from the one measured on the kept fields)."""
    S = tsv.Villain(tsv.Lattice2D(6), 0.5, W=float('inf'))
    e = tsv.Ensemble(S).generate(12, tsv.FusedHammer(S, sweeps_per_step=3), seed=2)
    assert e.phi.shape == (12, 1, 6, 6) and e.n.shape == (12, 2, 6, 6)
    assert all(S.valid({'n': torch.as_tensor(n)}) for n in e.n)
    assert e.stats['ExactNeighborhoodUpdate']['proposed'] == 12 * 3 * 36
    assert e.stats['ClassicWorm']['sweeps'] == 12
    assert e.Vortex_Vortex.shape == (12, 6, 6)
    np.testing.assert_array_equal(e.Worm_Length, e.Vortex_Vortex.sum(axis=(1, 2)))
    assert np.isfinite(tsv.Bootstrap(e.cut(4), seed=1).estimate('ActionDensity')).all()
