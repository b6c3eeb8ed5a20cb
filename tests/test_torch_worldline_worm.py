"""The port's plain Worldline worm (B5's twin), fed the JAX package's own draws,
reproduces ``ClassicWorm.step`` of the Worldline generators exactly (m, the
Spin_Spin histogram and the worm length), with and without a cap; a capped worm
that truncates is rolled back bit for bit at every W, W=1 included."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import supervillain_tpu as jsv
from supervillain_tpu.generators import worldline as jworldline
from supervillain_tpu_torch.interop import worldline_action, worldline_state_from_numpy
from supervillain_tpu_torch.ops.worldline_worm import (KernelWorldlineWormDraws,
                                                       WorldlineWormDraws, plain_worldline_worms,
                                                       worldline_worms)

from test_torch_worldline_model import _closed_m


class JaxWorldlineWormDraws:
    """The draws of the Worldline ``ClassicWorm.step`` for one worm per chain,
    with the JAX generator's own key splits (one key per chain), in dimension
    ``D``.  Its Metropolis uniform is drawn in the promotion of v's dtype with
    float32: float32 beside integer v, float64 beside float v (W=∞)."""

    def __init__(self, keys, N, accept_dtype, D=2):
        self.keys, self.N, self.accept_dtype, self.D = keys, N, accept_dtype, D

    def start(self):
        orientation, tail, self.loop = [], [], []
        for key in self.keys:
            k_orient, k_tail, k_loop = jax.random.split(key, 3)
            orientation.append(1 if bool(jax.random.bernoulli(k_orient)) else -1)
            tail.append(np.asarray(jax.random.randint(k_tail, (self.D,), 0, self.N)))
            self.loop.append(k_loop)
        return torch.tensor(orientation), torch.as_tensor(np.stack(tail))

    def move(self):
        u_close, choice, u_accept = [], [], []
        for c, key in enumerate(self.loop):
            key, k_close, k_choice, k_accept = jax.random.split(key, 4)
            self.loop[c] = key
            u_close.append(float(jax.random.uniform(k_close)))
            choice.append(int(jax.random.randint(k_choice, (), 0, 2 * self.D)))
            u_accept.append(float(jax.random.uniform(k_accept, dtype=self.accept_dtype)))
        return (torch.tensor(u_close, dtype=torch.float64), torch.tensor(choice),
                torch.tensor(u_accept, dtype=torch.float64))


@pytest.mark.parametrize('W,cap', [(1, None), (1, 3), (3, None), (float('inf'), 5)])
def test_plain_worm_reproduces_jax_step(W, cap):
    N, kappa, chains = 4, 0.3, 6
    rng = np.random.default_rng(41)
    S = jsv.Worldline(jsv.Lattice2D(N), kappa, W=W)
    step = jax.jit(jworldline.ClassicWorm(S, max_moves=cap).step)

    m0 = _closed_m(rng, N, chains)
    v0 = (rng.uniform(-1, 1, size=(chains, 1, N, N)) if W == float('inf')
          else rng.integers(-1, 2, size=(chains, 1, N, N)))
    keys = [jax.random.key(500 + c + (0 if cap is None else 50)) for c in range(chains)]
    want = {'m': [], 'hist': [], 'length': [], 'closed': []}
    for c in range(chains):
        stats = {'ClassicWorm': {k: jnp.zeros(()) for k in ('accepted', 'proposed', 'acceptance',
                                                            'sweeps')}}
        cfg, stats, inline = step(keys[c], {'m': jnp.asarray(m0[c]), 'v': jnp.asarray(v0[c])},
                                  stats)
        want['m'].append(np.asarray(cfg['m']))
        want['hist'].append(np.asarray(inline['Spin_Spin']))
        want['length'].append(float(inline['Worm_Length']))
        want['closed'].append(float(stats['ClassicWorm']['acceptance']))

    state = worldline_state_from_numpy({'m': m0, 'v': v0}, W, device='cpu')
    m, hist, length, truncated = plain_worldline_worms(
        state['m'], state['v'], kappa=kappa, W=W, worms=1, max_worm_moves=cap,
        draws=JaxWorldlineWormDraws(
            keys, N, jnp.float64 if W == float('inf') else jnp.float32))

    np.testing.assert_array_equal(m.numpy(), np.stack(want['m']))
    np.testing.assert_array_equal(hist.numpy(), np.stack(want['hist']))
    np.testing.assert_array_equal(length.numpy(), want['length'])
    np.testing.assert_array_equal(1.0 - truncated.numpy(), want['closed'])
    assert max(want['length']) > 0
    if cap is not None:
        assert truncated.sum() > 0, 'no worm truncated: the rollback went untested'


@pytest.mark.parametrize('W', [1, 2])
def test_plain_rollback_restores_m_bitwise(W):
    """A worm still open at the cap leaves m exactly as it found it, at W=1 as
    well (an open worldline worm breaks δm = 0 at every W)."""
    N, B = 6, 32
    S = worldline_action(N, 0.5, W)
    rng = np.random.default_rng(43)
    state = worldline_state_from_numpy({'m': _closed_m(rng, N, B),
                                        'v': rng.integers(-2, 3, size=(B, 1, N, N))}, W,
                                       device='cpu')
    g = torch.Generator().manual_seed(47)
    m, hist, length, truncated = plain_worldline_worms(
        state['m'], state['v'], kappa=S.kappa, W=W, worms=1, max_worm_moves=3,
        draws=WorldlineWormDraws(g, B=B, N=N, fdt=torch.float64, device='cpu'))
    rolled = truncated.bool()
    assert rolled.any() and (~rolled).any()
    assert torch.equal(m[rolled], state['m'][rolled])
    assert torch.equal(length, hist.sum(dim=(1, 2)))
    assert all(S.valid({'m': m[b]}) for b in range(B))


def test_kernel_draws_do_not_depend_on_the_batch():
    N, kappa = 6, 0.5
    S = worldline_action(N, kappa, 2)
    out = []
    for B in (2, 3):
        cold = S.initial('cpu')
        m, v = cold['m'].expand(B, -1, -1, -1), cold['v'].expand(B, -1, -1, -1)
        draws = KernelWorldlineWormDraws(99, B=B, N=N, device='cpu')
        out.append(plain_worldline_worms(m, v, kappa=kappa, W=2, worms=3, max_worm_moves=40,
                                         draws=draws))
    for a, b in zip(out[0], out[1]):
        assert torch.equal(a, b[:2])
    assert float(out[1][2].sum()) > 0
    assert all(S.valid({'m': out[1][0][b]}) for b in range(3))


def test_wrapper_on_cpu_runs_plain_worms():
    N, B = 4, 8
    S = worldline_action(N, 0.5, float('inf'))
    cold = S.initial('cpu')
    m, v = cold['m'].expand(B, -1, -1, -1), cold['v'].expand(B, -1, -1, -1)
    before = worldline_worms.launches
    m2, hist, length, truncated = worldline_worms(m, v, kappa=0.5, W=float('inf'), worms=3,
                                                  generator=torch.Generator().manual_seed(1))
    assert worldline_worms.launches == before
    assert hist.shape == (B, N, N) and length.shape == (B,) and truncated.shape == (B,)
    assert torch.equal(length, hist.sum(dim=(1, 2))) and float(length.sum()) > 0
    assert float(truncated.sum()) == 0
    assert all(S.valid({'m': m2[b]}) for b in range(B))
