"""The port's plain neighborhood sweep, fed the JAX package's own draws,
reproduces ``NeighborhoodUpdate.step`` and ``ExactNeighborhoodUpdate.step``:
φ to 1e-12, n and the accepted count exactly."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import supervillain_tpu as jsv
from supervillain_tpu.generators import base as jbase, villain as jvillain
from supervillain_tpu_torch.interop import state_from_numpy, villain_action
from supervillain_tpu_torch.ops import calculus as tcalc
from supervillain_tpu_torch.ops.sweep import neighborhood_sweeps, plain_sweeps

CASES = [
    # (update, W, interval, zero-inflation p)
    ('neighborhood', 1, 1, None),
    ('neighborhood', 2, 2, 0.3),
    ('exact', float('inf'), 1, None),
    ('exact', 1, 2, 0.4),
]


def _jax_draws(update, key, L, interval_phi, interval, p):
    """The draws of ``step`` for each color, recomputed with the JAX
    generators' own key splits."""
    f64 = jnp.float64

    def ints(k, shape):
        if p is None:
            return jbase.uniform_int_with_zero(k, shape, interval, dtype=jnp.int64)
        return jbase.zero_inflated_int(k, shape, interval, p, dtype=jnp.int64)

    out = []
    for ci in range(L.n_colors):
        sub = jax.random.fold_in(key, ci)
        if update == 'neighborhood':
            kp, kn, kb, km = jax.random.split(sub, 4)
            d = {'fwd': ints(kn, (2,) + L.dims), 'bwd': ints(kb, (2,) + L.dims)}
        else:
            kp, kz, km = jax.random.split(sub, 3)
            d = {'z': ints(kz, L.dims)}
        d['phi'] = jax.random.uniform(kp, L.dims, dtype=f64, minval=-interval_phi,
                                      maxval=interval_phi)
        d['u'] = jax.random.uniform(km, L.dims, dtype=f64)
        out.append({k: np.asarray(v) for k, v in d.items()})
    return out


@pytest.mark.parametrize('update,W,interval,p', CASES)
def test_plain_sweep_reproduces_jax_step(update, W, interval, p):
    N, kappa, interval_phi, chains = 6, 0.15, 2.0, 3
    rng = np.random.default_rng(17)
    L = jsv.Lattice2D(N)
    S = jsv.Villain(L, kappa, W=W)
    if update == 'neighborhood':
        G = jvillain.NeighborhoodUpdate(S, interval_phi, interval, p_n=p)
    else:
        G = jvillain.ExactNeighborhoodUpdate(S, interval_phi, interval, p_z=p)
    step = jax.jit(G.step)

    scale = 1 if W == float('inf') else W
    phi0 = rng.uniform(-np.pi, np.pi, size=(chains, 1, N, N))
    n0 = scale * rng.integers(-1, 2, size=(chains, 2, N, N))
    keys = [jax.random.key(100 + c) for c in range(chains)]

    want_phi, want_n, want_acc, draws = [], [], [], []
    for c in range(chains):
        cfg = {'phi': jnp.asarray(phi0[c]), 'n': jnp.asarray(n0[c])}
        cfg, stats, _ = step(keys[c], cfg, G.init_stats())
        want_phi.append(np.asarray(cfg['phi']))
        want_n.append(np.asarray(cfg['n']))
        want_acc.append(float(stats[G.name]['accepted']))
        draws.append(_jax_draws(update, keys[c], L, interval_phi, interval, p))
    batched = [{k: torch.as_tensor(np.stack([draws[c][ci][k] for c in range(chains)]))
                for k in draws[0][ci]} for ci in range(L.n_colors)]

    state = state_from_numpy({'phi': phi0, 'n': n0}, device='cpu')
    phi, n, accepted, _ = plain_sweeps(
        state['phi'], state['n'], kappa=kappa, W=float('inf') if update == 'exact' else W,
        sweeps=1, draws=lambda color: batched[color])

    assert sum(want_acc) > 0, 'no move accepted: the comparison would be vacuous'
    np.testing.assert_allclose(phi.numpy(), np.stack(want_phi), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(n.numpy(), np.stack(want_n))
    np.testing.assert_array_equal(accepted.numpy(), want_acc)


@pytest.mark.parametrize('W', [1, 2, float('inf')])
def test_wrapper_on_cpu_runs_plain_sweeps(W):
    """A CPU batch takes the plain path (no kernel launch), keeps the constraint,
    and its inline ActionDensity after one sweep equals (κ/2)Σr²/Λ of the output."""
    N, kappa, B = 4, 0.3, 5
    S = villain_action(N, kappa, W)
    phi = torch.zeros((B, 1, N, N), dtype=torch.float64)
    n = torch.zeros((B, 2, N, N), dtype=torch.int64)
    g = torch.Generator().manual_seed(3)
    before = neighborhood_sweeps.launches
    for _ in range(4):
        phi, n, accepted, inline = neighborhood_sweeps(
            phi, n, kappa=kappa, W=W, interval_phi=np.pi, interval_n=1, sweeps=1,
            p_n=0.2, generator=g)
    assert neighborhood_sweeps.launches == before
    assert accepted.shape == (B,) and float(accepted.sum()) > 0
    for b in range(B):
        assert S.valid({'n': n[b]})
    np.testing.assert_allclose(inline['ActionDensity'].numpy(), (S(phi, n) / N ** 2).numpy(),
                               rtol=1e-12)
    dn = tcalc.d(S.Lattice, 1, n).double()
    np.testing.assert_allclose(inline['WindingSquared'].numpy(),
                               dn.pow(2).mean(dim=(1, 2, 3)).numpy(), rtol=1e-12)


def test_wrapper_rejects_other_devices():
    phi = torch.zeros((1, 1, 4, 4), device='meta')
    n = torch.zeros((1, 2, 4, 4), dtype=torch.int32, device='meta')
    with pytest.raises(ValueError, match='CPU or a CUDA device'):
        neighborhood_sweeps(phi, n, kappa=0.5, W=1, interval_phi=1.0, interval_n=1,
                            sweeps=1, generator=torch.Generator())
