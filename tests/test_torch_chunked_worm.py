"""The port's ChunkedWorm micro-moves (K1's plain twin), fed the JAX package's
own draws, reproduce ``ChunkedWorm.step`` bit for bit in float64 (n, the
carried worm state, Vortex_Vortex, Worm_Length and the closes); K1's Philox
stream does not depend on the batch or on ``chain0``; the dispatcher runs the
plain twin on the CPU, the ``ChunkedWorm`` step goes through it, and any other
device raises."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import supervillain_tpu as jsv
import supervillain_tpu_torch as tsv
from supervillain_tpu.generators import villain as jvillain
from supervillain_tpu_torch.generators import villain as tv
from supervillain_tpu_torch.interop import state_from_numpy
from supervillain_tpu_torch.ops import kernels, shard
from supervillain_tpu_torch.ops.worm import (KernelChunkedWormDraws, chunked_worms,
                                             plain_chunked_worms)

KAPPA = 0.1


class JaxChunkedWormDraws:
    """The draws of the JAX ``ChunkedWorm.step``, one key per chain, with its
    own ``jax.random.split(key, 4)``: close and Metropolis uniforms in float64,
    choices, restarts and orientations."""

    def __init__(self, keys, N):
        self.keys, self.N = keys, N

    def chunk(self, T):
        u, choice, restart, orientation = [], [], [], []
        for key in self.keys:
            ku, kc, kr, ko = jax.random.split(key, 4)
            u.append(np.asarray(jax.random.uniform(ku, (T, 2), dtype=jnp.float64)))
            choice.append(np.asarray(jax.random.randint(kc, (T,), 0, 4)))
            restart.append(np.asarray(jax.random.randint(kr, (T, 4), 0, self.N)))
            orientation.append(np.where(np.asarray(jax.random.bernoulli(ko, 0.5, (T,))), 1, -1))
        u = torch.as_tensor(np.stack(u, axis=1))
        return (u[..., 0], torch.as_tensor(np.stack(choice, axis=1)), u[..., 1],
                torch.as_tensor(np.stack(restart, axis=1)),
                torch.as_tensor(np.stack(orientation, axis=1)))


class GeneratorChunkedWormDraws:
    """A draw source of :func:`plain_chunked_worms` from a ``torch.Generator``:
    for each of T micro-moves and each chain, the close uniform, the choice in
    0..3, the Metropolis uniform (T, B), the restart's tail and head (T, B, 4)
    and its orientation ±1 (T, B)."""

    def __init__(self, generator, *, B, N):
        self.generator, self.B, self.N = generator, B, N

    def chunk(self, T):
        g, B = self.generator, self.B
        u = torch.rand((T, 2, B), generator=g, dtype=torch.float64)
        choice = torch.randint(0, 4, (T, B), generator=g)
        restart = torch.randint(0, self.N, (T, B, 4), generator=g)
        orientation = 2 * torch.randint(0, 2, (T, B), generator=g) - 1
        return u[:, 0], choice, u[:, 1], restart, orientation


def _start(rng, N, chains):
    phi = rng.uniform(-np.pi, np.pi, size=(chains, 1, N, N))
    n = rng.integers(-1, 2, size=(chains, 2, N, N))
    worm = np.concatenate([rng.integers(0, N, size=(chains, 4)),
                           rng.choice([-1, 1], size=(chains, 1))], axis=1).astype(np.int32)
    return phi, n, worm


@pytest.mark.parametrize('N', [4, 5, 8])
@pytest.mark.parametrize('T', [1, 6, 64])
def test_plain_chunked_worm_reproduces_jax_step(N, T):
    chains = 5
    rng = np.random.default_rng(100 * N + T)
    S = jsv.Villain(jsv.Lattice2D(N), KAPPA, W=1)
    step = jax.jit(jvillain.ChunkedWorm(S, moves_per_step=T).step)
    phi0, n0, worm0 = _start(rng, N, chains)
    keys = [jax.random.key(31 * N + T + c) for c in range(chains)]

    want = {k: [] for k in ('n', 'worm', 'hist', 'length', 'closes')}
    for c in range(chains):
        stats = {'ClassicWorm': {k: jnp.zeros(()) for k in ('accepted', 'proposed', 'acceptance',
                                                            'sweeps')}}
        cfg = {'phi': jnp.asarray(phi0[c]), 'n': jnp.asarray(n0[c]), 'worm': jnp.asarray(worm0[c])}
        cfg, stats, inline = step(keys[c], cfg, stats)
        want['n'].append(np.asarray(cfg['n']))
        want['worm'].append(np.asarray(cfg['worm']))
        want['hist'].append(np.asarray(inline['Vortex_Vortex']))
        want['length'].append(float(inline['Worm_Length']))
        want['closes'].append(float(stats['ClassicWorm']['sweeps']))

    state = state_from_numpy({'phi': phi0, 'n': n0}, device='cpu')
    assert state['phi'].dtype == torch.float64
    n, worm, hist, length, closes = plain_chunked_worms(
        state['phi'], state['n'], torch.as_tensor(worm0), kappa=KAPPA, moves=T,
        draws=JaxChunkedWormDraws(keys, N))

    np.testing.assert_array_equal(n.numpy(), np.stack(want['n']))
    np.testing.assert_array_equal(worm.numpy(), np.stack(want['worm']))
    np.testing.assert_array_equal(hist.numpy(), np.stack(want['hist']))
    np.testing.assert_array_equal(length.numpy(), want['length'])
    np.testing.assert_array_equal(closes.numpy(), want['closes'])
    assert worm.dtype == torch.int32
    if T == 64:
        assert 0 < float(closes.sum()) < chains * T
        assert not torch.equal(n, state['n']), 'no move accepted: the Metropolis step went untested'


def _cold(N, B, seed=3):
    rng = np.random.default_rng(seed)
    phi, n, worm = _start(rng, N, B)
    state = state_from_numpy({'phi': phi, 'n': n}, device='cpu')
    return state['phi'], state['n'], torch.as_tensor(worm)


@pytest.mark.parametrize('N', [4, 5])
def test_kernel_draws_do_not_depend_on_the_batch_or_chain0(N):
    """Rows of a batch of 3 equal a batch of 2 (chain0 = 0) and a batch of one
    from chain0 = 2, draw for draw and output for output."""
    T = 40
    phi, n, worm = _cold(N, 3)
    whole = plain_chunked_worms(phi, n, worm, kappa=KAPPA, moves=T,
                                draws=KernelChunkedWormDraws(77, B=3, N=N, device='cpu'))
    first = plain_chunked_worms(phi[:2], n[:2], worm[:2], kappa=KAPPA, moves=T,
                                draws=KernelChunkedWormDraws(77, B=2, N=N, device='cpu'))
    last = plain_chunked_worms(phi[2:], n[2:], worm[2:], kappa=KAPPA, moves=T,
                               draws=KernelChunkedWormDraws(77, B=1, N=N, device='cpu',
                                                            chain0=2))
    for a, b, c in zip(whole, first, last):
        assert torch.equal(a[:2], b) and torch.equal(a[2:], c)
    assert float(whole[4].sum()) > 0 and float(whole[3].sum()) > 0
    a = KernelChunkedWormDraws(77, B=3, N=N, device='cpu').chunk(T)
    b = KernelChunkedWormDraws(78, B=3, N=N, device='cpu').chunk(T)
    assert not torch.equal(a[0], b[0]), 'another seed gave the same stream'


def test_kernel_stream_is_keyed_apart_from_the_classic_worms():
    """K1's key is the seed XOR its own salt, so its draws are neither B2's nor B5's."""
    from supervillain_tpu_torch.ops import philox
    keys = {philox.key_of(5), philox.worldline_key(5), philox.chunked_key(5)}
    assert len(keys) == 3


def test_draws_and_outputs_are_in_range():
    """Both draw sources give choices in 0..3, sites in [0, N), orientations
    ±1; every move is tallied or closes, so length + closes = T."""
    N, B, T = 5, 6, 30
    phi, n, worm = _cold(N, B)
    for draws in (KernelChunkedWormDraws(11, B=B, N=N, device='cpu'),
                  GeneratorChunkedWormDraws(torch.Generator().manual_seed(11), B=B, N=N)):
        u_close, choice, u_accept, restart, orientation = draws.chunk(T)
        assert u_close.shape == choice.shape == u_accept.shape == orientation.shape == (T, B)
        assert restart.shape == (T, B, 4)
        assert int(choice.min()) >= 0 and int(choice.max()) <= 3
        assert int(restart.min()) >= 0 and int(restart.max()) < N
        assert set(orientation.unique().tolist()) <= {-1, 1}
        assert float(u_close.min()) >= 0 and float(u_accept.max()) < 1
    for draws in (KernelChunkedWormDraws(12, B=B, N=N, device='cpu'),
                  GeneratorChunkedWormDraws(torch.Generator().manual_seed(12), B=B, N=N)):
        n2, worm2, hist, length, closes = plain_chunked_worms(phi, n, worm, kappa=KAPPA,
                                                               moves=T, draws=draws)
        assert torch.equal(length + closes, torch.full((B,), float(T), dtype=torch.float64))
        assert torch.equal(length, hist.sum(dim=(1, 2)))
        assert int(worm2[:, :4].min()) >= 0 and int(worm2[:, :4].max()) < N
        assert set(worm2[:, 4].tolist()) <= {-1, 1}


def test_dispatcher_runs_the_plain_twin_on_the_cpu():
    N, B, T = 4, 4, 25
    phi, n, worm = _cold(N, B)
    before = chunked_worms.launches
    got = chunked_worms(phi, n, worm, kappa=KAPPA, moves=T,
                        generator=torch.Generator().manual_seed(9))
    seed = kernels.seed_from(torch.Generator().manual_seed(9))
    want = plain_chunked_worms(phi, n, worm, kappa=KAPPA, moves=T,
                               draws=KernelChunkedWormDraws(seed, B=B, N=N, device='cpu'))
    assert chunked_worms.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_a_shard_draws_its_rows_of_the_fleet():
    """A shard's generator (chain0 = 1 of 4) gives the whole call's rows."""
    N, B, T = 5, 4, 20
    phi, n, worm = _cold(N, B)
    whole = chunked_worms(phi, n, worm, kappa=KAPPA, moves=T,
                          generator=torch.Generator().manual_seed(4))
    part = chunked_worms(phi[1:], n[1:], worm[1:], kappa=KAPPA, moves=T,
                         generator=shard.ShardGenerator(torch.Generator().manual_seed(4), 1, B))
    for a, b in zip(whole, part):
        assert torch.equal(a[1:], b)


def test_dispatcher_refuses_other_devices():
    phi = torch.zeros((2, 1, 4, 4), device='meta')
    n = torch.zeros((2, 2, 4, 4), dtype=torch.int32, device='meta')
    worm = torch.zeros((2, 5), dtype=torch.int32, device='meta')
    with pytest.raises(ValueError, match='CPU or a CUDA device'):
        chunked_worms(phi, n, worm, kappa=KAPPA, moves=4,
                      generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match='moves'):
        chunked_worms(phi, n, worm, kappa=KAPPA, moves=-1,
                      generator=torch.Generator().manual_seed(0))


def test_chunked_worm_step_goes_through_the_dispatcher(monkeypatch):
    """``ChunkedWorm.step`` makes one dispatcher call a step and keeps its
    stats, inline outputs and carried worm state as they were."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(kwargs['moves'])
        return chunked_worms(*args, **kwargs)

    monkeypatch.setattr(tv, 'chunked_worms', spy)
    S = tsv.Villain(tsv.Lattice2D(6), 0.3, W=1)
    G = tv.ChunkedWorm(S, moves_per_step=10)
    fleet = tsv.sample_fleet(S, G, chains=3, steps=4, thin=2, seed=2, device='cpu')
    assert calls == [10] * 8
    assert fleet.columns['worm'].shape == (4, 3, 5)
    assert fleet.columns['Vortex_Vortex'].shape == (4, 3, 6, 6)
    np.testing.assert_array_equal(fleet.columns['Worm_Length'],
                                  fleet.columns['Vortex_Vortex'].sum(axis=(2, 3)))
    s = fleet.stats['ClassicWorm']
    assert s['proposed'] + s['sweeps'] == 8 * 3 * 10
    assert G.report(fleet.stats).startswith('ChunkedWorm: ')
