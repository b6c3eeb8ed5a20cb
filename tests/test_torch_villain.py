"""The port's Villain action and observables against the JAX package, and the
numpy ↔ torch state carried between them."""

import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import supervillain_tpu as jsv
import supervillain_tpu_torch as tsv
from supervillain_tpu_torch.interop import state_from_numpy, state_to_numpy, villain_action


def _configurations(rng, N, W, count):
    phi = rng.uniform(-np.pi, np.pi, size=(count, 1, N, N))
    k = rng.integers(-2, 3, size=(count, 2, N, N))
    n = k if W == float('inf') else k * (1 if W == 1 else W)
    return {'phi': phi, 'n': n}


@pytest.mark.parametrize('N,kappa,W', [(4, 0.5, 1), (6, 0.3, 2), (5, 0.7, float('inf'))])
def test_action_matches_jax(N, kappa, W):
    rng = np.random.default_rng(N)
    ref = jsv.Villain(jsv.Lattice2D(N), kappa, W=W)
    ours = villain_action(N, kappa, W)
    cfgs = _configurations(rng, N, W, 3)
    state = state_from_numpy(cfgs)
    S_batch = ours(state['phi'], state['n']).numpy()
    for i in range(3):
        phi, n = jnp.asarray(cfgs['phi'][i]), jnp.asarray(cfgs['n'][i])
        np.testing.assert_allclose(S_batch[i], float(ref(phi, n)), rtol=1e-12)
        np.testing.assert_allclose(ours.links(state['phi'][i], state['n'][i]).numpy(),
                                   np.asarray(ref.links(phi, n)), rtol=0, atol=1e-12)
        np.testing.assert_allclose(ours.local(state['phi'][i], state['n'][i]).numpy(),
                                   np.asarray(ref.local(phi, n)), rtol=0, atol=1e-12)
        assert ours.valid({'n': state['n'][i]}) == ref.valid({'n': n})


def test_valid_detects_constraint_violation():
    S = villain_action(4, 0.5, 2)
    n = torch.zeros((2, 4, 4), dtype=torch.int64)
    assert S.valid({'n': n})
    n[0, 1, 2] = 1
    assert not S.valid({'n': n})
    assert villain_action(4, 0.5, 1).valid({'n': n})


@pytest.mark.parametrize('W', [1, 3])
def test_observables_match_jax(W):
    rng = np.random.default_rng(11 + W)
    N, kappa = 6, 0.4
    cfgs = _configurations(rng, N, W, 5)
    ref_e = jsv.Ensemble(jsv.Villain(jsv.Lattice2D(N), kappa, W=W)).from_configurations(
        jsv.Configurations(cfgs))
    ours_e = tsv.Ensemble(villain_action(N, kappa, W)).from_configurations(
        tsv.Configurations(cfgs))
    np.testing.assert_allclose(ours_e.ActionDensity, np.asarray(ref_e.ActionDensity),
                               rtol=1e-12, atol=1e-12)
    # The JAX package measures mean(dn²) in float32 (int64 promotes with float32
    # to float32 there); the mean of squared integers is exact before that final
    # rounding, so the port's float64 value rounds to the reference bit for bit.
    ref_w2 = np.asarray(ref_e.WindingSquared)
    assert ref_w2.dtype == np.float32
    np.testing.assert_array_equal(ours_e.WindingSquared.astype(np.float32), ref_w2)


def test_inline_column_short_circuits_measurement():
    cfgs = _configurations(np.random.default_rng(3), 4, 1, 2)
    cfgs['ActionDensity'] = np.array([1.5, 2.5])
    e = tsv.Ensemble(villain_action(4, 0.5, 1)).from_configurations(tsv.Configurations(cfgs))
    np.testing.assert_array_equal(e.ActionDensity, [1.5, 2.5])


def test_interop_round_trip():
    cfgs = _configurations(np.random.default_rng(5), 4, 2, 3)
    state = state_from_numpy(cfgs)
    assert state['phi'].dtype == torch.float64 and state['n'].dtype == torch.int64
    back = state_to_numpy(state)
    np.testing.assert_array_equal(back['phi'], cfgs['phi'])
    np.testing.assert_array_equal(back['n'], cfgs['n'])
    narrow = state_from_numpy(cfgs, dtypes=(torch.float32, torch.int32))
    assert narrow['phi'].dtype == torch.float32 and narrow['n'].dtype == torch.int32
    np.testing.assert_array_equal(state_to_numpy(narrow)['n'], cfgs['n'])
    S = villain_action(4, 0.5, 2)
    assert S == tsv.Villain(tsv.Lattice2D(4), 0.5, W=2)
    assert (S.Lattice.N, S.kappa, S.W) == (4, 0.5, 2)


def test_port_never_imports_jax():
    code = ('import sys, importlib, pkgutil, supervillain_tpu_torch as p\n'
            'for m in pkgutil.walk_packages(p.__path__, "supervillain_tpu_torch."):\n'
            '    importlib.import_module(m.name)\n'
            'bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")\n'
            '             or m.startswith("supervillain_tpu.") or m == "supervillain_tpu")\n'
            'assert not bad, bad\n')
    done = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr
