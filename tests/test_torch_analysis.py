"""The port's analysis layer against the JAX package's, on the CPU: the
bootstrap (same seed, same indices; every derived quantity), Uncertain
formatting, Blocking and the finite-size-scaling helpers."""

import logging

import numpy as np
import pytest

import supervillain_tpu as jsv
import supervillain_tpu_torch as tsv
from supervillain_tpu.analysis import scaling as jscaling
from supervillain_tpu_torch.analysis import scaling as tscaling
from supervillain_tpu_torch.utils import Timer
from test_torch_observables import CASES, assert_agree, ensembles
from test_uncertain_parity import CASES as UNCERTAIN_CASES

DERIVED = sorted(tsv.observables.derived_registry)


@pytest.fixture(scope='module', params=CASES, ids=lambda c: f'{c[0]}-N{c[1]}-W{c[2]}')
def bootstraps(request):
    ref, ours = ensembles(*request.param)
    return jsv.Bootstrap(ref, draws=40, seed=11), tsv.Bootstrap(ours, draws=40, seed=11)


@pytest.mark.parametrize('name', DERIVED)
def test_derived_quantity_matches_jax(bootstraps, name):
    ref, ours = bootstraps
    expect = np.asarray(getattr(ref, name))
    got = getattr(ours, name)
    assert np.iscomplexobj(got) == np.iscomplexobj(expect)
    # Action_Action is a difference of resampled values of order ActionTwoPoint.
    scale = np.abs(ref.ActionTwoPoint).max() if name == 'Action_Action' else None
    assert_agree(got, expect, scale=scale)


@pytest.mark.parametrize('name', ['ActionDensity', 'Spin_Spin', 'TorusWrapping', 'phi'])
def test_resampled_observables_match_jax(name):
    """Primary observables and fields resample as the JAX package resamples
    them: real, complex and integer columns, with non-uniform weights."""
    ref, ours = ensembles('Villain', 6, 2, count=30)
    weights = np.random.default_rng(4).uniform(0.5, 1.5, size=30)
    ref.weight = ours.weight = weights
    a, b = jsv.Bootstrap(ref, draws=25, seed=3), tsv.Bootstrap(ours, draws=25, seed=3)
    np.testing.assert_array_equal(b.indices, a.indices)
    assert_agree(getattr(b, name), getattr(a, name))
    m1, s1 = b.estimate(name)
    m2, s2 = a.estimate(name)
    assert_agree(m1, m2)
    assert_agree(s1, s2)


def test_bootstrap_of_per_chain_histograms():
    """The main path's measurement: derived quantities of inline worm
    histograms, one per chain, bootstrapped as one product."""
    rng = np.random.default_rng(8)
    hist = rng.integers(0, 50, size=(64, 8, 8)).astype(np.float32)
    hist[:, 0, 0] += 100
    for action in ('Villain', 'Worldline'):
        name = 'Vortex_Vortex' if action == 'Villain' else 'Spin_Spin'
        J = getattr(jsv, action)(jsv.Lattice2D(8), 0.5, W=2)
        T = getattr(tsv, action)(tsv.Lattice2D(8), 0.5, W=2)
        ref = jsv.Bootstrap(jsv.Ensemble(J).from_configurations(
            jsv.Configurations({name: hist})), draws=30, seed=5)
        ours = tsv.Bootstrap(tsv.Ensemble(T).from_configurations(
            tsv.Configurations({name: hist}), device='cpu'), draws=30, seed=5)
        prefix = 'Vortex' if action == 'Villain' else 'Spin'
        for derived in (f'{name}_Normalized', f'{prefix}Susceptibility',
                        f'{prefix}SusceptibilityScaled', f'{prefix}CriticalMoment'):
            assert_agree(getattr(ours, derived), getattr(ref, derived))


def test_bootstrap_with_one_draw_keeps_shapes():
    _, ours = ensembles('Worldline', 4, 2, count=5)
    b = tsv.Bootstrap(ours, draws=1, seed=0)
    assert b.Spin_Spin.shape == (1, 4, 4)
    assert b.SpinSusceptibility.shape == (1,)


@pytest.mark.parametrize('mean,err,spec,expect', UNCERTAIN_CASES)
def test_uncertain_formats_as_jax(mean, err, spec, expect):
    assert format(tsv.Uncertain(mean, err), spec) == expect
    assert format(tsv.Uncertain(mean, err), spec) == format(jsv.analysis.Uncertain(mean, err), spec)


@pytest.mark.parametrize('text', ['1.2346(32)', '9.109(28)E-31', '1.672(51) × 10^-27',
                                  '(1836.15 ± 0.01)', '+5.1099895000(15) × 10^-1'])
def test_uncertain_parses_as_jax(text):
    ours, ref = tsv.Uncertain.from_string(text), jsv.analysis.Uncertain.from_string(text)
    assert (ours.mean, ours.uncertainty) == (ref.mean, ref.uncertainty)
    for value in (tsv.Uncertain(3.14159, 0), tsv.Uncertain(1, 10), tsv.Uncertain(0, 0.5)):
        assert str(value) == str(jsv.analysis.Uncertain(value.mean, value.uncertainty))
    with pytest.raises(ValueError):
        format(tsv.Uncertain(1.0, 0.1), 'u2.3')


@pytest.mark.parametrize('width', [1, 3, 'auto'])
def test_blocking_matches_jax(width):
    ref, ours = ensembles('Villain', 6, 2, count=31)
    ref.weight = ours.weight = np.linspace(0.5, 1.5, 31)
    a, b = jsv.Blocking(ref, width=width), tsv.Blocking(ours, width=width)
    assert (b.width, b.blocks, b.drop, len(b)) == (a.width, a.blocks, a.drop, len(a))
    np.testing.assert_array_equal(b.index, a.index)
    assert b.index_stride == a.index_stride
    assert_agree(b.weight, a.weight)
    for name in ('ActionDensity', 'Spin_Spin'):
        assert_agree(getattr(b, name), np.asarray(getattr(a, name)))
    # A bootstrap of the blocks runs where the ensemble measures.
    assert_agree(tsv.Bootstrap(b, draws=10, seed=2).SpinSusceptibility,
                 jsv.Bootstrap(a, draws=10, seed=2).SpinSusceptibility)


def test_scaling_helpers_match_jax():
    kappas = [0.07, 0.08, 0.09, 0.1]
    scaled = {64: np.array([1.3, 1.0, 0.8, 0.7]), 128: np.array([1.2, 0.9, 0.6, 0.5]),
              256: np.array([1.5, 0.9, 0.4, 0.2])}
    errs = {L: np.full(4, 0.03) for L in scaled}
    calls = (lambda m: m.scaled_susceptibility(64.0, 256, Delta=0.5),
             lambda m: m.scaled_susceptibility([32.0, 8.0], 64, Delta=0.125, D=3),
             lambda m: m.effective_exponent(128, 100.0, 256, 336.0),
             lambda m: m.effective_exponent_error(128, 100.0, 1.0, 256, 175.0, 2.0),
             lambda m: m.crossing_estimate(kappas, scaled),
             lambda m: m.crossing_estimate(kappas, {1: scaled[64], 2: scaled[64] + 1}),
             lambda m: m.crossing_estimate_error(kappas, scaled, errs, draws=200),
             lambda m: m.crossing_estimate_error(kappas, scaled, errs, pair=(64, 128), seed=3))
    for f in calls:
        ours, ref = f(tscaling), f(jscaling)
        if ref is None or isinstance(ref, tuple) and ref[0] is None:
            assert ours == ref
        else:
            np.testing.assert_allclose(np.asarray(ours, dtype=float), np.asarray(ref, dtype=float),
                                       rtol=1e-12, atol=0)


def test_timer_logs_elapsed_time(caplog):
    with caplog.at_level(logging.INFO):
        with Timer(logging.getLogger('timer').info, 'work', per=4) as t:
            sum(range(1000))
    assert t.elapsed >= 0
    assert 'work [' in caplog.text and 'each)' in caplog.text
    with Timer(None) as quiet:
        pass
    assert quiet.elapsed >= 0


def test_bootstrapping_logs_its_time(caplog):
    _, ours = ensembles('Villain', 4, 1, count=6)
    with caplog.at_level(logging.INFO, logger='supervillain_tpu_torch.analysis.bootstrap'):
        tsv.Bootstrap(ours, draws=3, seed=0).ActionDensity
    assert 'Bootstrapping ActionDensity' in caplog.text
