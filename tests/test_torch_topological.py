"""The port's topological-charge observables against the JAX package's, on
fixed D=4 Villain configurations made from a seed with NumPy, measured on the
CPU by both packages' ensembles: to 1e-12 (relative to the largest magnitude),
and the derived connected correlator through both bootstraps on one seed.
The JAX package squares and correlates the integer charge density in float32
(int64 promotes with float32 to float32 there, as for the Villain winding); the
port does so in float64, so those three are held to float32 rounding against
the JAX values and to 1e-12 against the JAX formulas evaluated in float64.
Both packages refuse them below D=4, and the port registers them as the JAX
package does."""

import numpy as np
import pytest

import supervillain_tpu as jsv
import supervillain_tpu_torch as tsv
from supervillain_tpu.observables import registry as jregistry

TOL = 1e-12
#: Squared or correlated in float32 by the JAX package.
FLOAT32_IN_JAX = {'TopologicalChargeDensitySquared', 'TopologicalTwoPoint',
                  'Topological_Topological'}
FLOAT32_TOL = 2e-6
NAMES = ['TopologicalChargeDensity', 'TopologicalCharge', 'TopologicalChargeDensitySquared',
         'TopologicalTwoPoint']


def configurations(N, W, count=12, seed=0):
    """φ uniform and n in W·{-1, 0, 1} (mostly 0), so dn and Q are non-trivial."""
    rng = np.random.default_rng([seed, N])
    k = rng.choice([-1, 0, 1], p=[0.2, 0.6, 0.2], size=(count, 4) + (N,) * 4)
    return {'phi': rng.uniform(-np.pi, np.pi, size=(count, 1) + (N,) * 4), 'n': k * W}


@pytest.fixture(scope='module', params=[(3, 1), (4, 2)], ids=lambda c: f'N{c[0]}-W{c[1]}')
def pair(request):
    N, W = request.param
    cfgs = configurations(N, W)
    J = jsv.Villain(jsv.Lattice(4, N), 0.4, W=W)
    T = tsv.Villain(tsv.Lattice(4, N), 0.4, W=W)
    return (jsv.Ensemble(J).from_configurations(jsv.Configurations(cfgs)),
            tsv.Ensemble(T).from_configurations(tsv.Configurations(cfgs), device='cpu'))


def assert_agree(ours, ref, tol=TOL):
    ref = np.asarray(ref)
    assert np.shape(ours) == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize('name', NAMES)
def test_observable_matches_jax(pair, name):
    ref, ours = pair
    assert_agree(getattr(ours, name), getattr(ref, name),
                 FLOAT32_TOL if name in FLOAT32_IN_JAX else TOL)


def test_squares_match_the_jax_formulas_in_float64(pair):
    """mean(q²) and the correlation of q, from the JAX package's own (integer)
    charge density and its lattice's correlation, in float64."""
    ref, ours = pair
    q = np.asarray(ref.TopologicalChargeDensity).astype(np.float64)
    L = ref.Action.Lattice
    assert_agree(ours.TopologicalChargeDensitySquared, (q ** 2).mean(axis=(1, 2, 3, 4)))
    assert_agree(ours.TopologicalTwoPoint,
                 np.stack([np.asarray(L.correlation(x, x).real) for x in q]))


def test_charge_is_exact_and_its_square_nonzero(pair):
    """Q = Σ_x q_x vanishes configuration by configuration on the torus, while
    the local charge fluctuates."""
    _, ours = pair
    np.testing.assert_array_equal(ours.TopologicalCharge, 0)
    assert (ours.TopologicalChargeDensitySquared > 0).any()


def test_connected_correlator_matches_jax(pair):
    ref, ours = pair
    want = np.asarray(jsv.Bootstrap(ref, draws=20, seed=3).Topological_Topological)
    got = tsv.Bootstrap(ours, draws=20, seed=3).Topological_Topological
    assert_agree(got, want, FLOAT32_TOL)


def test_registered_as_the_jax_package_registers_them():
    for name in NAMES:
        assert name in tsv.observables.registry and name in jregistry
    assert 'Topological_Topological' in tsv.observables.derived_registry
    from supervillain_tpu_torch import observable
    assert observable.TopologicalCharge is tsv.observables.TopologicalCharge


@pytest.mark.parametrize('D', [2, 3])
def test_below_d4_both_packages_refuse(D):
    N = 3
    cfgs = {'phi': np.zeros((2, 1) + (N,) * D), 'n': np.zeros((2, D) + (N,) * D, dtype=int)}
    ours = tsv.Ensemble(tsv.Villain(tsv.Lattice(D, N), 0.4)).from_configurations(
        tsv.Configurations(cfgs), device='cpu')
    with pytest.raises(NotImplementedError, match='D = 4'):
        ours.TopologicalChargeDensity
    ref = jsv.Ensemble(jsv.Villain(jsv.Lattice(D, N), 0.4)).from_configurations(
        jsv.Configurations(cfgs))
    with pytest.raises(NotImplementedError, match='D = 4'):
        ref.TopologicalChargeDensity
    assert 'TopologicalChargeDensity' not in ours.measure()
