"""The Worldline worm at D >= 3 (K2's plain twin), fed the JAX package's own
draws, reproduces ``ClassicWorm.step`` at D = 3 and 4 with and without a cap
(m, Spin_Spin, Worm_Length, the closed flag); a capped worm that truncates is
rolled back bit for bit; K2's Philox stream (that of
``KernelWorldlineWormDraws`` with ``D``) does not depend on the batch or on
``chain0``; the dispatcher ``worldline_worms_general`` runs the plain twin on
that stream on the CPU (the D >= 3 path as it was), ``ClassicWorm`` at
D >= 3 goes through it, and any other device raises."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import supervillain_tpu as jsv
import supervillain_tpu_torch as tsv
from supervillain_tpu.generators import worldline as jworldline
from supervillain_tpu_torch.generators import worldline as tw
from supervillain_tpu_torch.interop import worldline_action, worldline_state_from_numpy
from supervillain_tpu_torch.ops import calculus, kernels, shard
from supervillain_tpu_torch.ops.worldline_worm import (KernelWorldlineWormDraws,
                                                       WorldlineWormDraws, plain_worldline_worms,
                                                       worldline_worms_general)

from test_torch_worldline_worm import JaxWorldlineWormDraws

INF = float('inf')


def _closed_m(rng, D, N, count):
    """Integer 1-forms with δm = 0 at dimension D: δ of random integer 2-forms."""
    L = tsv.Lattice(D, N)
    C = D * (D - 1) // 2
    return calculus.delta(L, 2, torch.as_tensor(rng.integers(-1, 2, size=(count, C) + L.dims)))


def _state(rng, D, N, W, chains, dtypes=None):
    m = _closed_m(rng, D, N, chains).numpy()
    shape = (chains, D * (D - 1) // 2) + (N,) * D
    v = rng.uniform(-1, 1, size=shape) if W == INF else rng.integers(-1, 2, size=shape)
    return m, v, worldline_state_from_numpy({'m': m, 'v': v}, W, device='cpu', dtypes=dtypes)


@pytest.mark.parametrize('D,W,cap', [(3, 1, None), (3, 2, 5), (3, INF, None), (3, 1, 4),
                                     (4, 1, None), (4, 2, 5), (4, INF, 3)])
def test_plain_worm_reproduces_jax_step_at_d3_and_d4(D, W, cap):
    """int32 fields at finite W, so that the port's float type is JAX's
    promotion of v with float32 (float32), and float64 v at W = ∞."""
    N, kappa, chains = 3, 0.3, 4
    rng = np.random.default_rng(10 * D + (3 if W == INF else W))
    S = jsv.Worldline(jsv.Lattice(D, N), kappa, W=W)
    step = jax.jit(jworldline.ClassicWorm(S, max_moves=cap).step)
    dtypes = (torch.float64, torch.int64) if W == INF else (torch.float32, torch.int32)
    m0, v0, state = _state(rng, D, N, W, chains, dtypes)
    if W != INF:
        m0, v0 = m0.astype(np.int32), v0.astype(np.int32)
    keys = [jax.random.key(900 + 10 * D + c + (0 if cap is None else 50)) for c in range(chains)]
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

    m, hist, length, truncated = plain_worldline_worms(
        state['m'], state['v'], kappa=kappa, W=W, worms=1, max_worm_moves=cap,
        draws=JaxWorldlineWormDraws(keys, N, jnp.float64 if W == INF else jnp.float32, D=D))

    np.testing.assert_array_equal(m.numpy(), np.stack(want['m']))
    np.testing.assert_array_equal(hist.numpy(), np.stack(want['hist']))
    np.testing.assert_array_equal(length.numpy(), want['length'])
    np.testing.assert_array_equal(1.0 - truncated.numpy(), want['closed'])
    assert max(want['length']) > 0
    if cap is not None and W != INF:
        assert truncated.sum() > 0, 'no worm truncated: the rollback went untested'


@pytest.mark.parametrize('D', [3, 4])
@pytest.mark.parametrize('W', [1, 2])
def test_rollback_restores_m_bitwise(D, W):
    """A worm still open at the cap leaves m exactly as it found it; the
    others keep δm = 0."""
    N, B = 3, 24
    rng = np.random.default_rng(60 + D + W)
    _, _, state = _state(rng, D, N, W, B)
    m, hist, length, truncated = plain_worldline_worms(
        state['m'], state['v'], kappa=0.5, W=W, worms=1, max_worm_moves=3,
        draws=WorldlineWormDraws(torch.Generator().manual_seed(D + W), B=B, N=N,
                                 fdt=torch.float64, device='cpu', D=D))
    rolled = truncated.bool()
    assert rolled.any() and (~rolled).any()
    assert torch.equal(m[rolled], state['m'][rolled])
    assert torch.equal(length, hist.sum(dim=tuple(range(1, D + 1))))
    L = tsv.Lattice(D, N)
    assert bool((calculus.delta(L, 1, m) == 0).all())


@pytest.mark.parametrize('D', [3, 4])
def test_kernel_draws_do_not_depend_on_the_batch_or_chain0(D):
    """Rows of a batch of 3 equal a batch of 2 (chain0 = 0) and a batch of one
    from chain0 = 2, with three capped worms a chain."""
    N = 3
    rng = np.random.default_rng(D)
    _, _, state = _state(rng, D, N, 2, 3)
    m, v = state['m'], state['v']
    common = dict(kappa=0.5, W=2, worms=3, max_worm_moves=40)
    whole = plain_worldline_worms(m, v, draws=KernelWorldlineWormDraws(
        99, B=3, N=N, device='cpu', D=D), **common)
    first = plain_worldline_worms(m[:2], v[:2], draws=KernelWorldlineWormDraws(
        99, B=2, N=N, device='cpu', D=D), **common)
    last = plain_worldline_worms(m[2:], v[2:], draws=KernelWorldlineWormDraws(
        99, B=1, N=N, device='cpu', chain0=2, D=D), **common)
    for a, b, c in zip(whole, first, last):
        assert torch.equal(a[:2], b) and torch.equal(a[2:], c)
    assert float(whole[2].sum()) > 0


@pytest.mark.parametrize('D', [3, 4, 5])
def test_kernel_draws_cover_every_choice_and_coordinate(D):
    """The start words give every coordinate of the tail (past the third from
    the counters j = 1, 2, ...) and the choice spans 0..2D−1."""
    N = 5
    draws = KernelWorldlineWormDraws(3, B=64, N=N, device='cpu', D=D)
    orientation, tail = draws.start()
    assert tail.shape == (64, D) and int(tail.min()) >= 0 and int(tail.max()) < N
    assert all(len(tail[:, k].unique()) > 1 for k in range(D))
    assert set(orientation.tolist()) == {-1, 1}
    choices = torch.cat([draws.move()[1] for _ in range(8)])
    assert set(choices.tolist()) == set(range(2 * D))


@pytest.mark.parametrize('D', [3, 4])
def test_dispatcher_runs_the_parents_d3_path_on_the_cpu(D):
    """On the CPU the dispatcher is the plain twin on K2's stream, seeded from
    the generator and counted from the shard's chain0: the D >= 3 worm's
    results as they were."""
    N, B = 3, 5
    rng = np.random.default_rng(70 + D)
    _, _, state = _state(rng, D, N, 1, B)
    before = worldline_worms_general.launches
    for g, chain0 in ((torch.Generator().manual_seed(5), 0),
                      (shard.ShardGenerator(torch.Generator().manual_seed(5), 2, B + 2), 2)):
        got = worldline_worms_general(state['m'], state['v'], kappa=0.4, W=1, worms=2,
                                      max_worm_moves=30, generator=g)
        seed = kernels.seed_from(torch.Generator().manual_seed(5))
        want = plain_worldline_worms(state['m'], state['v'], kappa=0.4, W=1, worms=2,
                                     max_worm_moves=30, draws=KernelWorldlineWormDraws(
                                         seed, B=B, N=N, device='cpu', chain0=chain0, D=D))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert worldline_worms_general.launches == before


def test_dispatcher_refuses_other_devices():
    m = torch.zeros((2, 3, 4, 4, 4), dtype=torch.int32, device='meta')
    v = torch.zeros((2, 3, 4, 4, 4), dtype=torch.int32, device='meta')
    with pytest.raises(ValueError, match='CPU or a CUDA device'):
        worldline_worms_general(m, v, kappa=0.5, W=2, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize('D', [3, 4])
def test_classic_worm_at_d3_goes_through_the_dispatcher(monkeypatch, D):
    calls = []

    def spy(*args, **kwargs):
        calls.append(kwargs['max_worm_moves'])
        return worldline_worms_general(*args, **kwargs)

    monkeypatch.setattr(tw, 'worldline_worms_general', spy)
    S = worldline_action(3, 0.4, 2, D=D)
    fleet = tsv.sample_fleet(S, tw.Hammer(S, fleet=True), chains=2, steps=3, thin=1, seed=1,
                             device='cpu')
    assert calls == [tw.FLEET_CAP_PER_SITE * 3 ** D] * 3
    assert S.valid({'m': torch.as_tensor(fleet.final['m'][0])})
