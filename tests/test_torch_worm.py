"""The port's plain classic worm, fed the JAX package's own draws, reproduces
``ClassicWorm.step`` exactly (n, the Vortex_Vortex histogram and the worm
length), including the capped worm's rollback at W=2."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import supervillain_tpu as jsv
from supervillain_tpu.generators import villain as jvillain
from supervillain_tpu_torch.interop import state_from_numpy, villain_action
from supervillain_tpu_torch.ops.worm import WormDraws, classic_worms, plain_worms


class JaxWormDraws:
    """The draws of ``ClassicWorm.step`` for one worm per chain, with the JAX
    generator's own key splits (one key per chain)."""

    def __init__(self, keys, N):
        self.keys, self.N = keys, N

    def start(self):
        orientation, tail, head, self.loop = [], [], [], []
        for key in self.keys:
            k_orient, k_tail, k_head, k_loop = jax.random.split(key, 4)
            orientation.append(1 if bool(jax.random.bernoulli(k_orient)) else -1)
            tail.append(np.asarray(jax.random.randint(k_tail, (2,), 0, self.N)))
            head.append(np.asarray(jax.random.randint(k_head, (2,), 0, self.N)))
            self.loop.append(k_loop)
        return (torch.tensor(orientation), torch.as_tensor(np.stack(tail)),
                torch.as_tensor(np.stack(head)))

    def move(self):
        u_close, choice, u_accept = [], [], []
        for c, key in enumerate(self.loop):
            key, k_close, k_choice, k_accept = jax.random.split(key, 4)
            self.loop[c] = key
            u_close.append(float(jax.random.uniform(k_close)))
            choice.append(int(jax.random.randint(k_choice, (), 0, 4)))
            u_accept.append(float(jax.random.uniform(k_accept, dtype=jnp.float64)))
        return (torch.tensor(u_close, dtype=torch.float64), torch.tensor(choice),
                torch.tensor(u_accept, dtype=torch.float64))


@pytest.mark.parametrize('W,cap', [(1, None), (1, 3), (2, None), (2, 3)])
def test_plain_worm_reproduces_jax_step(W, cap):
    N, kappa, chains = 4, 0.3, 6
    rng = np.random.default_rng(23 + W)
    S = jsv.Villain(jsv.Lattice2D(N), kappa, W=W)
    G = jvillain.ClassicWorm(S, max_moves=cap)
    step = jax.jit(G.step)

    # Small residuals (n = 0): from a start with large ones an uncapped W=2 worm
    # can run away downhill and take arbitrarily long to close.
    phi0 = rng.uniform(-0.5, 0.5, size=(chains, 1, N, N))
    n0 = np.zeros((chains, 2, N, N), dtype=np.int64)
    keys = [jax.random.key(7 * W + c + (0 if cap is None else 50)) for c in range(chains)]

    want = {'n': [], 'hist': [], 'length': [], 'closed': []}
    for c in range(chains):
        cfg = {'phi': jnp.asarray(phi0[c]), 'n': jnp.asarray(n0[c])}
        cfg, stats, inline = step(keys[c], cfg, G.init_stats())
        want['n'].append(np.asarray(cfg['n']))
        want['hist'].append(np.asarray(inline['Vortex_Vortex']))
        want['length'].append(float(inline['Worm_Length']))
        want['closed'].append(float(stats['ClassicWorm']['acceptance']))

    state = state_from_numpy({'phi': phi0, 'n': n0}, device='cpu')
    n, hist, length, truncated = plain_worms(
        state['phi'], state['n'], kappa=kappa, W=W, worms=1, max_worm_moves=cap,
        draws=JaxWormDraws(keys, N))

    np.testing.assert_array_equal(n.numpy(), np.stack(want['n']))
    np.testing.assert_array_equal(hist.numpy(), np.stack(want['hist']))
    np.testing.assert_array_equal(length.numpy(), want['length'])
    np.testing.assert_array_equal(1.0 - truncated.numpy(), want['closed'])
    if W == 2 and cap is not None:
        assert truncated.sum() > 0, 'no worm truncated: the rollback went untested'


def test_plain_rollback_restores_n_bitwise():
    """At W=2 a worm still open at the cap leaves n exactly as it found it, and
    every chain keeps dn ≡ 0 (mod 2)."""
    N, B = 6, 32
    S = villain_action(N, 0.1, 2)
    rng = np.random.default_rng(29)
    state = state_from_numpy({'phi': rng.uniform(-1, 1, size=(B, 1, N, N)),
                              'n': 2 * rng.integers(-1, 2, size=(B, 2, N, N))}, device='cpu')
    g = torch.Generator().manual_seed(31)
    n, hist, length, truncated = plain_worms(
        state['phi'], state['n'], kappa=S.kappa, W=2, worms=1, max_worm_moves=2,
        draws=WormDraws(g, B=B, N=N, fdt=torch.float64, device='cpu'))
    rolled = truncated.bool()
    assert rolled.any() and (~rolled).any()
    torch.testing.assert_close(n[rolled], state['n'][rolled], rtol=0, atol=0)
    assert torch.equal(length, hist.sum(dim=(1, 2)))
    for b in range(B):
        assert S.valid({'n': n[b]})


def test_wrapper_on_cpu_runs_plain_worms():
    N, B = 4, 8
    phi = torch.zeros((B, 1, N, N), dtype=torch.float64)
    n = torch.zeros((B, 2, N, N), dtype=torch.int64)
    before = classic_worms.launches
    n2, hist, length, truncated = classic_worms(
        phi, n, kappa=0.5, W=1, worms=3, generator=torch.Generator().manual_seed(1))
    assert classic_worms.launches == before
    assert hist.shape == (B, N, N) and length.shape == (B,) and truncated.shape == (B,)
    assert torch.equal(length, hist.sum(dim=(1, 2))) and float(length.sum()) > 0
    assert float(truncated.sum()) == 0
