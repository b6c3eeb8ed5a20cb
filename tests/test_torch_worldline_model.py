"""The port's Worldline action and observables against the JAX package, and the
numpy ↔ torch Worldline state carried between them."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import supervillain_tpu as jsv
import supervillain_tpu_torch as tsv
from supervillain_tpu_torch.interop import (state_to_numpy, worldline_action,
                                            worldline_state_from_numpy)

WS = [1, 3, float('inf')]


def _closed_m(rng, N, count):
    """Integer 1-forms with δm = 0: δ of random integer 2-forms plus straight
    wrapping cycles."""
    L = tsv.Lattice2D(N)
    t = torch.as_tensor(rng.integers(-2, 3, size=(count, 1, N, N)))
    m = tsv.ops.calculus.delta(L, 2, t)
    m[:, 0] += torch.as_tensor(rng.integers(-1, 2, size=(count, 1, N)))
    m[:, 1] += torch.as_tensor(rng.integers(-1, 2, size=(count, N, 1)))
    return m.numpy()


def _configurations(rng, N, W, count):
    if W == float('inf'):
        v = rng.uniform(-3, 3, size=(count, 1, N, N))
    else:
        v = rng.integers(-2 * W, 2 * W + 1, size=(count, 1, N, N))
    return {'m': _closed_m(rng, N, count), 'v': v}


@pytest.mark.parametrize('W', WS)
def test_action_matches_jax(W):
    N, kappa = 6, 0.4
    rng = np.random.default_rng(61)
    ref = jsv.Worldline(jsv.Lattice2D(N), kappa, W=W)
    ours = worldline_action(N, kappa, W)
    cfgs = _configurations(rng, N, W, 3)
    state = worldline_state_from_numpy(cfgs, W, device='cpu')
    energies = ours.energy(state['m'], state['v']).numpy()
    for i in range(3):
        m, v = jnp.asarray(cfgs['m'][i]), jnp.asarray(cfgs['v'][i])
        np.testing.assert_allclose(ours.links(state['m'][i], state['v'][i]).numpy(),
                                   np.asarray(ref.links(m, v)), rtol=0, atol=1e-12)
        np.testing.assert_allclose(energies[i], float(ref.energy(m, v)), rtol=1e-12)
        np.testing.assert_allclose(float(ours(state['m'][i], state['v'][i])), float(ref(m, v)),
                                   rtol=1e-12)
        assert ours.valid({'m': state['m'][i]}) and ref.valid({'m': m})
        want = ref.equivalence_class_v({'m': m, 'v': v})
        got = ours.equivalence_class_v({'m': state['m'][i], 'v': state['v'][i]})
        np.testing.assert_array_equal(got['m'].numpy(), np.asarray(want['m']))
        np.testing.assert_array_equal(got['v'].numpy(), np.asarray(want['v']))
        if W != float('inf'):
            assert int(got['v'].min()) >= 0 and int(got['v'].max()) < W


@pytest.mark.parametrize('W', WS)
def test_valid_and_call_reject_a_broken_constraint(W):
    S = worldline_action(6, 0.4, W)
    ref = jsv.Worldline(jsv.Lattice2D(6), 0.4, W=W)
    cfg = S.initial('cpu')
    cfg['m'][0, 2, 3] = 1
    assert not S.valid(cfg) and not ref.valid({'m': jnp.asarray(cfg['m'].numpy())})
    with pytest.raises(ValueError, match='δm = 0'):
        S(cfg['m'], cfg['v'])


@pytest.mark.parametrize('W', WS)
def test_observables_match_jax(W):
    N, kappa = 6, 0.4
    cfgs = _configurations(np.random.default_rng(67), N, W, 5)
    ref = jsv.Ensemble(jsv.Worldline(jsv.Lattice2D(N), kappa, W=W)).from_configurations(
        jsv.Configurations(cfgs))
    ours = tsv.Ensemble(worldline_action(N, kappa, W)).from_configurations(
        tsv.Configurations(cfgs))
    np.testing.assert_allclose(ours.Links, np.asarray(ref.Links), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.ActionDensity, np.asarray(ref.ActionDensity), rtol=1e-12)


@pytest.mark.parametrize('W', WS)
def test_state_dtypes_and_round_trip(W):
    S = worldline_action(4, 0.5, W)
    cold = S.initial('cpu')
    assert cold['m'].dtype == torch.int64 and cold['m'].shape == (2, 4, 4)
    assert cold['v'].dtype == (torch.float64 if W == float('inf') else torch.int64)
    assert cold['v'].shape == (1, 4, 4)
    cfgs = _configurations(np.random.default_rng(5), 4, W, 2)
    state = worldline_state_from_numpy(cfgs, W, device='cpu')
    assert state['v'].dtype == cold['v'].dtype
    back = state_to_numpy(state)
    np.testing.assert_array_equal(back['m'], cfgs['m'])
    np.testing.assert_array_equal(back['v'], cfgs['v'])
    narrow = worldline_state_from_numpy(cfgs, W, device='cpu', dtypes=(torch.float32, torch.int32))
    assert narrow['m'].dtype == torch.int32
    assert narrow['v'].dtype == (torch.float32 if W == float('inf') else torch.int32)
    assert S == tsv.Worldline(tsv.Lattice2D(4), 0.5, W=W) and S != worldline_action(4, 0.6, W)
    assert S._W == (2 * np.pi if W == float('inf') else W)
