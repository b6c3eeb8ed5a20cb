"""The port's plain Worldline sweep (B4's twin), fed the JAX package's own draws,
reproduces one ``VortexUpdate``, ``CoexactUpdate`` and ``WrappingUpdate`` step
each, composed in the kernel's order: m, v and the accepted counts exactly (v
to 1e-12 at W=∞).  One sweep only: with more, the JAX package's CPU fallback
orders the updates differently from the kernel."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import supervillain_tpu as jsv
from supervillain_tpu.generators import base as jbase, worldline as jworldline
import supervillain_tpu_torch as tsv
from supervillain_tpu_torch.interop import worldline_action, worldline_state_from_numpy
from supervillain_tpu_torch.ops.worldline import (KernelWorldlineSweepDraws, MAX_CHAINS, PASSES,
                                                  plain_worldline_sweeps, sweep_scratch,
                                                  worldline_sweeps)

from test_torch_worldline_model import _closed_m

CASES = [
    # (W, kappa, interval_v, interval_t, interval_w)
    (1, 0.8, 1, 1, 1),
    (2, 0.6, 2, 2, 1),
    (float('inf'), 0.7, 0.8, 1, 2),
]


def _jax_draws(keys, L, S, intervals):
    """The draws of the three steps, recomputed with the JAX generators' own
    key splits (generators/worldline.py), in the order of PASSES."""
    interval_v, interval_t, interval_w = intervals
    kv, kc, kw = keys
    f64 = jnp.float64
    out = []
    for ci in range(2):
        k1, k2 = jax.random.split(jax.random.fold_in(kv, ci))
        if S.W == float('inf'):
            change = jax.random.uniform(k1, L.dims, dtype=f64, minval=-interval_v,
                                        maxval=interval_v)
        else:
            change = jbase.uniform_nonzero_int(k1, L.dims, interval_v, dtype=jnp.int64)
        out.append({'v': change, 'u': jax.random.uniform(k2, L.dims, dtype=f64)})
    for ci in range(2):
        k1, k2 = jax.random.split(jax.random.fold_in(kc, ci))
        out.append({'t': jbase.uniform_nonzero_int(k1, L.dims, interval_t, dtype=jnp.int64),
                    'u': jax.random.uniform(k2, L.dims, dtype=f64)})
    for mu in range(2):
        k1, k2 = jax.random.split(jax.random.fold_in(kw, mu))
        perp = (1, L.N) if mu == 0 else (L.N, 1)
        out.append({'w': jbase.uniform_nonzero_int(k1, perp, interval_w, dtype=jnp.int64).reshape(-1),
                    'u': jax.random.uniform(k2, perp, dtype=f64).reshape(-1)})
    return [{k: np.asarray(v) for k, v in d.items()} for d in out]


@pytest.mark.parametrize('W,kappa,interval_v,interval_t,interval_w', CASES)
def test_plain_sweep_reproduces_jax_steps(W, kappa, interval_v, interval_t, interval_w):
    N, chains = 6, 6
    rng = np.random.default_rng(71)
    L = jsv.Lattice2D(N)
    S = jsv.Worldline(L, kappa, W=W)
    steps = [jax.jit(G.step) for G in (jworldline.VortexUpdate(S, interval_v),
                                       jworldline.CoexactUpdate(S, interval_t),
                                       jworldline.WrappingUpdate(S, interval_w))]
    names = ('VortexUpdate', 'CoexactUpdate', 'WrappingUpdate')

    m0 = _closed_m(rng, N, chains)
    v0 = (rng.uniform(-2, 2, size=(chains, 1, N, N)) if W == float('inf')
          else rng.integers(-2, 3, size=(chains, 1, N, N)))
    want_m, want_v, want_acc, draws = [], [], np.zeros((chains, 3)), []
    for c in range(chains):
        keys = [jax.random.key(300 + 3 * c + i) for i in range(3)]
        cfg = {'m': jnp.asarray(m0[c]), 'v': jnp.asarray(v0[c])}
        for i, (step, name) in enumerate(zip(steps, names)):
            stats = {name: {k: jnp.zeros(()) for k in ('accepted', 'proposed', 'acceptance',
                                                       'sweeps')}}
            cfg, stats, _ = step(keys[i], cfg, stats)
            want_acc[c, i] = float(stats[name]['accepted'])
        want_m.append(np.asarray(cfg['m']))
        want_v.append(np.asarray(cfg['v']))
        draws.append(_jax_draws(keys, L, S, (interval_v, interval_t, interval_w)))
    assert (want_acc.sum(axis=0) > 0).all(), 'a pass accepted nothing: the comparison is vacuous'
    batched = [{k: torch.as_tensor(np.stack([draws[c][p][k] for c in range(chains)]))
                for k in draws[0][p]} for p in range(len(PASSES))]
    calls = iter(range(len(PASSES)))

    def source(kind, index):
        p = next(calls)
        assert PASSES[p] == (kind, index)
        return batched[p]

    state = worldline_state_from_numpy({'m': m0, 'v': v0}, W, device='cpu')
    m, v, accepted, inline = plain_worldline_sweeps(state['m'], state['v'], kappa=kappa, W=W,
                                                    sweeps=1, draws=source)
    np.testing.assert_array_equal(m.numpy(), np.stack(want_m))
    if W == float('inf'):
        np.testing.assert_allclose(v.numpy(), np.stack(want_v), rtol=0, atol=1e-12)
    else:
        np.testing.assert_array_equal(v.numpy(), np.stack(want_v))
    np.testing.assert_array_equal(accepted.numpy(), want_acc.sum(axis=1))


@pytest.mark.parametrize('W', [1, 2, float('inf')])
def test_wrapper_on_cpu_keeps_constraint_and_inline_action(W):
    """A CPU batch takes the plain path (no kernel launch) and keeps δm = 0.
    The inline ActionDensity of a one-sweep call is (1/2κ)Σu²/Λ of its output,
    u = m − δv/_W: 1 minus the registry observable of that name."""
    N, kappa, B = 6, 0.5, 4
    S = worldline_action(N, kappa, W)
    cold = S.initial('cpu')
    m, v = cold['m'].expand(B, -1, -1, -1), cold['v'].expand(B, -1, -1, -1)
    g = torch.Generator().manual_seed(3)
    before = worldline_sweeps.launches
    for sweeps in (3, 3, 1):
        m, v, accepted, inline = worldline_sweeps(m, v, kappa=kappa, W=W, interval_v=1,
                                                  sweeps=sweeps, generator=g)
    assert worldline_sweeps.launches == before
    assert accepted.shape == (B,) and float(accepted.sum()) > 0
    assert all(S.valid({'m': m[b]}) for b in range(B))
    u = S.links(m, v)
    np.testing.assert_allclose(inline['ActionDensity'].numpy(),
                               (0.5 / kappa * (u * u).sum(dim=(1, 2, 3)) / N ** 2).numpy(),
                               rtol=1e-12)
    e = tsv.Ensemble(S).from_configurations(tsv.Configurations({'m': m.numpy(), 'v': v.numpy()}))
    np.testing.assert_allclose(inline['ActionDensity'].numpy(), 1 - e.ActionDensity, rtol=1e-12)


@pytest.mark.parametrize('W', [2, float('inf')])
def test_kernel_draws_do_not_depend_on_the_batch(W):
    """Chain c's trajectory under the kernel's draws is the same in a batch of
    2 and of 3, and the plain version keeps δm = 0 under them."""
    N, kappa = 6, 0.5
    S = worldline_action(N, kappa, W)
    out = []
    for B in (2, 3):
        cold = S.initial('cpu')
        m, v = cold['m'].expand(B, -1, -1, -1), cold['v'].expand(B, -1, -1, -1)
        draws = KernelWorldlineSweepDraws(1234, B=B, N=N, interval_v=1, interval_t=1,
                                          interval_w=1, winf=W == float('inf'),
                                          fdt=torch.float64, idt=torch.int64, device='cpu')
        out.append(plain_worldline_sweeps(m, v, kappa=kappa, W=W, sweeps=4, draws=draws))
    for a, b in zip(out[0][:3], out[1][:3]):
        assert torch.equal(a, b[:2])
    assert float(out[1][2].sum()) > 0
    assert all(S.valid({'m': out[1][0][b]}) for b in range(3))


def test_wrapper_rejects_other_devices():
    m = torch.zeros((1, 2, 4, 4), dtype=torch.int32, device='meta')
    v = torch.zeros((1, 1, 4, 4), dtype=torch.int32, device='meta')
    with pytest.raises(ValueError, match='CPU or a CUDA device'):
        worldline_sweeps(m, v, kappa=0.5, W=1, sweeps=1, generator=torch.Generator())


@pytest.mark.parametrize('W', [2, float('inf')])
def test_sweep_scratch_matches_the_fields(W):
    """The kernel's scratch: v, T and u in its private layout (the public
    fields' sizes) and two numbers per cycle, 2N per chain."""
    vdt = torch.float32 if W == float('inf') else torch.int32
    m = torch.zeros((3, 2, 6, 6), dtype=torch.int32)
    v = torch.zeros((3, 1, 6, 6), dtype=vdt)
    scratch = sweep_scratch(m, v)
    assert {k: (tuple(t.shape), t.dtype) for k, t in scratch.items()} == {
        'v': ((3, 1, 6, 6), vdt), 't': ((3, 1, 6, 6), torch.int32),
        'u': ((3, 2, 6, 6), torch.float32), 'shifts': ((3, 12), torch.int32),
        'squares': ((3, 12), torch.float64)}
    assert MAX_CHAINS == 2 ** 16 - 1
