"""Tests of the CUDA kernels themselves; they need an NVIDIA GPU and skip without one.

On a machine with a card (which need not have JAX):

    python -m pytest --noconftest -o addopts='' -m cuda tests/test_torch_cuda.py -q
"""

import math

import pytest
import torch

from supervillain_tpu_torch.interop import villain_action, worldline_action
from supervillain_tpu_torch.ops import calculus, kernels
from supervillain_tpu_torch.ops.hammer import hammer_sweeps
from supervillain_tpu_torch.ops.sweep import (KernelSweepDraws, lattice, neighborhood_sweeps,
                                              plain_sweeps)
from supervillain_tpu_torch.ops.worm import KernelWormDraws, classic_worms, plain_worms
from supervillain_tpu_torch.ops.worldline import (KernelWorldlineSweepDraws,
                                                  plain_worldline_sweeps, worldline_sweeps)
from supervillain_tpu_torch.ops.worldline_hammer import worldline_hammer_sweeps
from supervillain_tpu_torch.ops.worldline_worm import (KernelWorldlineWormDraws,
                                                       plain_worldline_worms, worldline_worms)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')


def _cold(B, N, device):
    return (torch.zeros((B, 1, N, N), dtype=torch.float32, device=device),
            torch.zeros((B, 2, N, N), dtype=torch.int32, device=device))


def _sweeps(phi, n, W, sweeps, seed):
    return neighborhood_sweeps(phi, n, kappa=0.4, W=W, interval_phi=math.pi, interval_n=1,
                               sweeps=sweeps, p_n=0.3, generator=torch.Generator().manual_seed(seed))


def test_kernels_reject_what_they_do_not_take(cuda):
    phi, n = _cold(2, 6, cuda)
    with pytest.raises(ValueError, match='even N'):
        _sweeps(*_cold(2, 5, cuda), 1, 1, 0)
    with pytest.raises(TypeError, match='float32'):
        _sweeps(phi.double(), n, 1, 1, 0)
    with pytest.raises(ValueError, match='contiguous'):
        _sweeps(phi.transpose(2, 3), n, 1, 1, 0)
    with pytest.raises(ValueError, match='n must be'):
        classic_worms(phi, n[:, :1], kappa=0.4, W=1, generator=torch.Generator())


@pytest.mark.parametrize('W', [1, 2, float('inf')])
def test_sweep_kernel_keeps_constraint_and_inline_action(cuda, W):
    S = villain_action(8, 0.4, W)
    phi, n = _cold(64, 8, cuda)
    before = neighborhood_sweeps.launches
    for seed in range(3):
        phi, n, accepted, _ = _sweeps(phi, n, W, 7, seed)
    phi1, n1, _, inline = _sweeps(phi, n, W, 1, 9)
    assert neighborhood_sweeps.launches == before + 4
    assert float(accepted.sum()) > 0
    assert all(S.valid({'n': n1[b]}) for b in range(64))
    r = calculus.d(lattice(8), 0, phi1.double()) - 2 * math.pi * n1.double()
    torch.testing.assert_close(inline['ActionDensity'].double(),
                               0.2 * (r * r).sum(dim=(1, 2, 3)) / 64, rtol=1e-5, atol=0)


@pytest.mark.parametrize('W', [1, 2, float('inf')])
def test_kernels_repeat_their_plain_versions_on_the_same_draws(cuda, W):
    """Fed the kernels' own Philox draws, the plain versions repeat the kernel
    calls.  Only float rounding of ΔS (summation order, exp2f against exp) may
    flip a Metropolis decision, at well under 1e-3 of the sites or chains."""
    B, N, kappa = 64, 8, 0.4
    phi = (torch.rand((B, 1, N, N), generator=torch.Generator().manual_seed(1)) - 0.5).to(cuda)
    _, n = _cold(B, N, cuda)
    seed = kernels.seed_from(torch.Generator().manual_seed(5))
    got = _sweeps(phi, n, W, 6, 5)
    draws = KernelSweepDraws(seed, B=B, N=N, interval_phi=math.pi, interval_n=1, p_n=0.3,
                             zmode=W == float('inf'), fdt=torch.float32, idt=torch.int32,
                             device=cuda)
    want = plain_sweeps(phi, n, kappa=kappa, W=W, sweeps=6, draws=draws)
    assert float((got[0] != want[0]).float().mean()) <= 1e-3
    assert float((got[1] != want[1]).float().mean()) <= 1e-3
    torch.testing.assert_close(got[3]['ActionDensity'], want[3]['ActionDensity'],
                               rtol=1e-4, atol=0)

    phi, n = got[0], got[1]
    cap = None if W == 1 else 16
    worm = classic_worms(phi, n, kappa=kappa, W=W, worms=4, max_worm_moves=cap,
                         generator=torch.Generator().manual_seed(6))
    want = plain_worms(phi, n, kappa=kappa, W=W, worms=4, max_worm_moves=cap,
                       draws=KernelWormDraws(kernels.seed_from(torch.Generator().manual_seed(6)),
                                             B=B, N=N, device=cuda))
    same = [(a == b).reshape(B, -1).all(dim=1) for a, b in zip(worm, want)]
    assert float(torch.stack(same).all(dim=0).float().mean()) >= 1 - 1 / B


def test_kernels_are_deterministic_for_a_seed(cuda):
    phi, n = _cold(16, 8, cuda)
    a = hammer_sweeps(phi, n, kappa=0.4, W=2, interval_phi=1.0, interval_n=1, sweeps=5,
                      worms=3, max_worm_moves=32, generator=torch.Generator().manual_seed(4))
    b = hammer_sweeps(phi, n, kappa=0.4, W=2, interval_phi=1.0, interval_n=1, sweeps=5,
                      worms=3, max_worm_moves=32, generator=torch.Generator().manual_seed(4))
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    for k in a[3]:
        assert torch.equal(a[3][k], b[3][k])


def test_worm_rollback_restores_n_bitwise(cuda):
    phi = torch.rand((128, 1, 8, 8), device=cuda) - 0.5
    _, n = _cold(128, 8, cuda)
    n_out, hist, length, truncated = classic_worms(
        phi, n, kappa=0.1, W=2, worms=1, max_worm_moves=3,
        generator=torch.Generator().manual_seed(2))
    rolled = truncated.bool()
    assert rolled.any() and (~rolled).any()
    assert torch.equal(n_out[rolled], n[rolled])
    assert torch.equal(length, hist.sum(dim=(1, 2)))
    S = villain_action(8, 0.1, 2)
    assert all(S.valid({'n': n_out[b]}) for b in range(128))


# -- the Worldline kernels (B4–B6) ---------------------------------------------

def _cold_worldline(B, N, W, device):
    vdt = torch.float32 if W == float('inf') else torch.int32
    return (torch.zeros((B, 2, N, N), dtype=torch.int32, device=device),
            torch.zeros((B, 1, N, N), dtype=vdt, device=device))


def _worldline_sweeps(m, v, W, sweeps, seed):
    return worldline_sweeps(m, v, kappa=0.5, W=W, interval_v=1, sweeps=sweeps,
                            generator=torch.Generator().manual_seed(seed))


def _worldline_sweep_draws(seed, B, N, W, device):
    winf = W == float('inf')
    return KernelWorldlineSweepDraws(kernels.seed_from(torch.Generator().manual_seed(seed)), B=B,
                                     N=N, interval_v=1.0 if winf else 1, interval_t=1,
                                     interval_w=1, winf=winf, fdt=torch.float32, idt=torch.int32,
                                     device=device)


def test_worldline_kernels_reject_what_they_do_not_take(cuda):
    m, v = _cold_worldline(2, 6, 2, cuda)
    with pytest.raises(ValueError, match='even N'):
        _worldline_sweeps(*_cold_worldline(2, 5, 2, cuda), 2, 1, 0)
    with pytest.raises(TypeError, match='int32 m'):
        _worldline_sweeps(m, v.float(), 2, 1, 0)
    with pytest.raises(TypeError, match='int32 m'):
        _worldline_sweeps(m, v, float('inf'), 1, 0)
    with pytest.raises(ValueError, match='contiguous'):
        _worldline_sweeps(m.transpose(2, 3), v, 2, 1, 0)
    with pytest.raises(ValueError, match='v must be'):
        worldline_worms(m, v[:1], kappa=0.5, W=2, generator=torch.Generator())
    with pytest.raises(ValueError, match='max_worm_moves'):
        worldline_worms(m, v, kappa=0.5, W=2, max_worm_moves=2 ** 31, generator=torch.Generator())
    with pytest.raises(ValueError, match='at most 65535 chains'):
        _worldline_sweeps(*_cold_worldline(65536, 2, 2, cuda), 2, 1, 0)


@pytest.mark.parametrize('W', [1, 2, float('inf')])
def test_worldline_sweep_kernel_keeps_constraint_and_inline_action(cuda, W):
    S = worldline_action(8, 0.5, W)
    m, v = _cold_worldline(64, 8, W, cuda)
    before = worldline_sweeps.launches
    for seed in range(3):
        m, v, accepted, _ = _worldline_sweeps(m, v, W, 7, seed)
    m1, v1, _, inline = _worldline_sweeps(m, v, W, 1, 9)
    assert worldline_sweeps.launches == before + 4
    assert float(accepted.sum()) > 0
    assert bool((calculus.delta(lattice(8), 1, m1) == 0).all())
    u = S.links(m1.long(), v1.double() if W == float('inf') else v1.long())
    torch.testing.assert_close(inline['ActionDensity'].double(),
                               (u * u).sum(dim=(1, 2, 3)) / 64, rtol=1e-5, atol=0)


@pytest.mark.parametrize('W', [1, 2, 3, float('inf')])
def test_worldline_kernels_repeat_their_plain_versions_on_the_same_draws(cuda, W):
    """Fed the kernels' own Philox draws, the plain versions repeat the kernel
    calls up to decisions flipped by float rounding of ΔS.  W=3 makes 1/W
    inexact, where any change to the residual's rounding would show."""
    B, N, kappa = 64, 8, 0.5
    m, v = _cold_worldline(B, N, W, cuda)
    m, v, _, _ = _worldline_sweeps(m, v, W, 20, 4)
    got = _worldline_sweeps(m, v, W, 6, 5)
    want = plain_worldline_sweeps(m, v, kappa=kappa, W=W, sweeps=6,
                                  draws=_worldline_sweep_draws(5, B, N, W, cuda))
    assert float((got[0] != want[0]).float().mean()) <= 1e-3
    assert float((got[1] != want[1]).float().mean()) <= 1e-3
    torch.testing.assert_close(got[3]['ActionDensity'], want[3]['ActionDensity'],
                               rtol=1e-4, atol=0)

    m, v = got[0], got[1]
    worm = worldline_worms(m, v, kappa=kappa, W=W, worms=4, max_worm_moves=64,
                           generator=torch.Generator().manual_seed(6))
    want = plain_worldline_worms(
        m, v, kappa=kappa, W=W, worms=4, max_worm_moves=64,
        draws=KernelWorldlineWormDraws(kernels.seed_from(torch.Generator().manual_seed(6)),
                                       B=B, N=N, device=cuda))
    same = [(a == b).reshape(B, -1).all(dim=1) for a, b in zip(worm, want)]
    assert float(torch.stack(same).all(dim=0).float().mean()) >= 1 - 1 / B
    assert float(worm[2].sum()) > 0


def test_worldline_worm_rollback_restores_m_bitwise_at_w1(cuda):
    m, v = _cold_worldline(128, 8, 1, cuda)
    m, v, _, _ = _worldline_sweeps(m, v, 1, 10, 1)
    m_out, hist, length, truncated = worldline_worms(
        m, v, kappa=0.5, W=1, worms=1, max_worm_moves=3,
        generator=torch.Generator().manual_seed(2))
    rolled = truncated.bool()
    assert rolled.any() and (~rolled).any()
    assert torch.equal(m_out[rolled], m[rolled])
    assert torch.equal(length, hist.sum(dim=(1, 2)))
    assert bool((calculus.delta(lattice(8), 1, m_out) == 0).all())


def test_worldline_hammer_is_deterministic_for_a_seed(cuda):
    m, v = _cold_worldline(16, 8, 2, cuda)
    before = worldline_hammer_sweeps.launches
    a, b = (worldline_hammer_sweeps(m, v, kappa=0.5, W=2, sweeps=5, worms=3, max_worm_moves=32,
                                    generator=torch.Generator().manual_seed(4)) for _ in range(2))
    assert worldline_hammer_sweeps.launches == before + 2
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    for k in a[3]:
        assert torch.equal(a[3][k], b[3][k])


@pytest.mark.parametrize('W', [2, float('inf')])
def test_worldline_sweep_kernel_on_a_ragged_grid(cuda, W):
    """B=37 chains of N=6: neither fills the kernel's blocks of 32 lanes by 8
    rows, and N/2 = 3 sites per color row is odd."""
    B, N = 37, 6
    m, v = _cold_worldline(B, N, W, cuda)
    m, v, _, _ = _worldline_sweeps(m, v, W, 30, 7)
    got = _worldline_sweeps(m, v, W, 10, 8)
    want = plain_worldline_sweeps(m, v, kappa=0.5, W=W, sweeps=10,
                                  draws=_worldline_sweep_draws(8, B, N, W, cuda))
    assert float((got[0] != want[0]).float().mean()) <= 1e-3
    assert float((got[1] != want[1]).float().mean()) <= 1e-3
    assert float(got[2].sum()) > 0
    torch.testing.assert_close(got[3]['ActionDensity'], want[3]['ActionDensity'],
                               rtol=1e-4, atol=0)
    assert bool((calculus.delta(lattice(N), 1, got[0]) == 0).all())


def test_worldline_worms_truncate_and_roll_back_after_closed_worms(cuda):
    """Three worms per chain under a cap of 37 moves: closed worms and
    truncated ones (whose logs end mid-word) follow each other in one call.
    The kernel repeats its plain twin on its own draws, and a chain whose every
    worm was truncated gets its m back bit for bit."""
    B, N, W, worms, cap = 128, 8, 2, 3, 37
    m, v = _cold_worldline(B, N, W, cuda)
    m, v, _, _ = _worldline_sweeps(m, v, W, 20, 3)
    seed = 9
    got = worldline_worms(m, v, kappa=0.5, W=W, worms=worms, max_worm_moves=cap,
                          generator=torch.Generator().manual_seed(seed))
    want = plain_worldline_worms(
        m, v, kappa=0.5, W=W, worms=worms, max_worm_moves=cap,
        draws=KernelWorldlineWormDraws(kernels.seed_from(torch.Generator().manual_seed(seed)),
                                       B=B, N=N, device=cuda))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    m_out, hist, length, truncated = got
    assert torch.equal(length, hist.sum(dim=(1, 2)))
    assert bool((truncated > 0).any()) and bool((truncated < worms).any())
    every = truncated == worms
    assert bool(every.any())
    assert torch.equal(m_out[every], m[every])
    assert bool((calculus.delta(lattice(N), 1, m_out) == 0).all())


@pytest.mark.parametrize('N, W, cap', [(6, 2, None), (6, 2, 29), (10, float('inf'), None),
                                       (10, 3, 53)])
def test_worldline_worms_at_n_not_a_power_of_two(cuda, N, W, cap):
    """At N = 6 and 10, with and without a cap, three worms per chain repeat
    their plain twin bit for bit on the kernel's own draws: the heads and
    links of moves three ahead wrap at both edges, and truncated worms replay
    their logs across the edges."""
    B, worms, seed = 64, 3, 12
    m, v = _cold_worldline(B, N, W, cuda)
    m, v, _, _ = _worldline_sweeps(m, v, W, 20, 5)
    got = worldline_worms(m, v, kappa=0.5, W=W, worms=worms, max_worm_moves=cap,
                          generator=torch.Generator().manual_seed(seed))
    want = plain_worldline_worms(
        m, v, kappa=0.5, W=W, worms=worms, max_worm_moves=cap,
        draws=KernelWorldlineWormDraws(kernels.seed_from(torch.Generator().manual_seed(seed)),
                                       B=B, N=N, device=cuda))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    m_out, hist, length, truncated = got
    assert torch.equal(length, hist.sum(dim=(1, 2)))
    assert bool((truncated > 0).any()) == (cap is not None)
    assert bool((calculus.delta(lattice(N), 1, m_out) == 0).all())
