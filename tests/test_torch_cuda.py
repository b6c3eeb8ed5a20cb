"""Tests of the CUDA kernels themselves; they need an NVIDIA GPU and skip without one.

On a machine with a card (which need not have JAX):

    python -m pytest --noconftest -o addopts='' -m cuda tests/test_torch_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

import supervillain_tpu_torch as tsv
from supervillain_tpu_torch.interop import villain_action, worldline_action
from supervillain_tpu_torch.ops import calculus, kernels
from supervillain_tpu_torch.ops.hammer import hammer_sweeps
from supervillain_tpu_torch.ops.sweep import (STREAMING_PLAN, TABLE_PLAN, KernelSweepDraws,
                                              SweepPlan, kernel_sweeps, lattice,
                                              neighborhood_sweeps, plain_sweeps, streaming_sums,
                                              sum_bands, sweep_plan)
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
    with pytest.raises(ValueError, match='N >= 2'):
        _sweeps(*_cold(2, 1, cuda), 1, 1, 0)
    with pytest.raises(ValueError, match='table plan'):
        kernel_sweeps(*_cold(2, 5, cuda), STREAMING_PLAN, kappa=0.4, W=1, interval_phi=1.0,
                      interval_n=1, sweeps=1, generator=torch.Generator())
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


# -- the sweep kernel's two regimes (csrc/sweep.cu, ops/sweep.py sweep_plan) ------

# (W, interval_n, p_n): plain draws; zero-inflated with the third Philox call;
# z-mode, zero-inflated.
SWEEP_MODES = [(1, 1, None), (2, 2, 0.3), (float('inf'), 1, 0.3)]


def _warm(B, N, W, seed, device):
    """Random φ in ±4π and n in W·{-1, 0, 1}: every residual far from zero."""
    g = torch.Generator().manual_seed(seed)
    phi = (torch.rand((B, 1, N, N), generator=g) - 0.5) * 8 * math.pi
    n = torch.randint(-1, 2, (B, 2, N, N), generator=g, dtype=torch.int32)
    return phi.to(device), (n * (1 if W == float('inf') else W)).to(device)


def _plan_sweeps(phi, n, plan, mode, sweeps, seed):
    W, interval_n, p_n = mode
    return kernel_sweeps(phi, n, plan, kappa=0.4, W=W, interval_phi=1.5, interval_n=interval_n,
                         sweeps=sweeps, p_n=p_n, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize('mode', SWEEP_MODES)
@pytest.mark.parametrize('N', [2, 6, 10, 130, 250, 256])
def test_resident_sweeps_repeat_their_plain_version(cuda, N, mode):
    """The resident kernel (one block at N = 2, 6, 10; a cluster of 2 at 130;
    of 8 with bands of 31 and 32 rows at 250; of 8 at the main path's 256)
    against the plain version on the kernel's own draws."""
    plan = sweep_plan(N)
    assert plan.regime == 'resident'
    B, sweeps = (64, 6) if N <= 10 else (3, 2)
    W, interval_n, p_n = mode
    phi, n = _warm(B, N, W, N, cuda)
    before = neighborhood_sweeps.launches
    got = neighborhood_sweeps(phi, n, kappa=0.4, W=W, interval_phi=1.5, interval_n=interval_n,
                              sweeps=sweeps, p_n=p_n, generator=torch.Generator().manual_seed(3))
    assert neighborhood_sweeps.launches == before + 1
    draws = KernelSweepDraws(kernels.seed_from(torch.Generator().manual_seed(3)), B=B, N=N,
                             interval_phi=1.5, interval_n=interval_n, p_n=p_n,
                             zmode=W == float('inf'), fdt=torch.float32, idt=torch.int32,
                             device=cuda)
    want = plain_sweeps(phi, n, kappa=0.4, W=W, sweeps=sweeps, draws=draws)
    assert float(got[2].sum()) > 0
    assert float((got[0] != want[0]).float().mean()) <= 1e-3
    assert float((got[1] != want[1]).float().mean()) <= 1e-3
    assert float((got[2] - want[2]).abs().max()) <= max(2.0, 1e-3 * N * N * sweeps)
    for k in ('ActionDensity', 'WindingSquared'):
        torch.testing.assert_close(got[3][k], want[3][k], rtol=1e-4, atol=0)


@pytest.mark.parametrize('N', [2, 6, 130, 250, 256])
def test_resident_and_streaming_regimes_agree_bit_for_bit(cuda, N):
    """Both regimes run one transition on the same draws: the same φ, n and
    accepted counts, and inline sums equal up to their summation order."""
    for mode in SWEEP_MODES:
        phi, n = _warm(4, N, mode[0], 7, cuda)
        resident = _plan_sweeps(phi, n, sweep_plan(N), mode, 3, 11)
        streaming = _plan_sweeps(phi, n, STREAMING_PLAN, mode, 3, 11)
        for a, b in zip(resident[:3], streaming[:3]):
            assert torch.equal(a, b)
        for k in ('ActionDensity', 'WindingSquared'):
            torch.testing.assert_close(resident[3][k], streaming[3][k], rtol=1e-6, atol=0)


def test_streaming_sweeps_at_n512_repeat_their_plain_version(cuda):
    N, B, mode = 512, 2, SWEEP_MODES[1]
    assert sweep_plan(N) == STREAMING_PLAN
    phi, n = _warm(B, N, mode[0], 5, cuda)
    got = neighborhood_sweeps(phi, n, kappa=0.4, W=2, interval_phi=1.5, interval_n=2, sweeps=2,
                              p_n=0.3, generator=torch.Generator().manual_seed(4))
    draws = KernelSweepDraws(kernels.seed_from(torch.Generator().manual_seed(4)), B=B, N=N,
                             interval_phi=1.5, interval_n=2, p_n=0.3, zmode=False,
                             fdt=torch.float32, idt=torch.int32, device=cuda)
    want = plain_sweeps(phi, n, kappa=0.4, W=2, sweeps=2, draws=draws)
    assert float((got[0] != want[0]).float().mean()) <= 1e-3
    assert float((got[1] != want[1]).float().mean()) <= 1e-3
    torch.testing.assert_close(got[3]['ActionDensity'], want[3]['ActionDensity'],
                               rtol=1e-4, atol=0)


@pytest.mark.parametrize('N, bands', [(310, 7), (311, None), (1024, 33), (1024, None)])
def test_streaming_sums_equal_a_float64_recomputation(cuda, N, bands):
    """The streaming inline sums of one sweep, alone, in several bands a chain
    (7, 33 and the default 5 at N=311 do not divide N; the default at N=1024
    is 64 bands of 16 rows): Σ r² to float64 rounding, Σ (dn)² exactly."""
    B = 3
    g = torch.Generator().manual_seed(N)
    r = ((torch.rand((B, 2, N, N), generator=g) - 0.5) * 8 * math.pi).to(cuda)
    n = torch.randint(-3, 4, (B, 2, N, N), generator=g, dtype=torch.int32).to(cuda)
    k = sum_bands(N) if bands is None else bands
    assert k > 1 and (bands is None or N % k)
    got = streaming_sums(r, n, bands)
    dn = calculus.d(lattice(N), 1, n.long())
    torch.testing.assert_close(got[:, 0], (r.double() ** 2).sum(dim=(1, 2, 3)), rtol=1e-12,
                               atol=0)
    assert torch.equal(got[:, 1], (dn * dn).sum(dim=(1, 2, 3)).double())
    assert torch.equal(streaming_sums(r, n, bands), got)


@pytest.mark.parametrize('N', [310, 1024])
def test_streaming_sweeps_sum_the_fields_they_leave(cuda, N):
    """The streaming plan at B=3, in 5 and 64 bands a chain: a sweep's inline
    WindingSquared is Σ (dn)² of the output n exactly, its ActionDensity that
    of the output fields up to the residual's float32 drift; two calls on one
    seed give the same sums bit for bit."""
    B, mode = 3, SWEEP_MODES[1]
    phi, n = _warm(B, N, mode[0], 9, cuda)
    phi1, n1, _, inline = _plan_sweeps(phi, n, STREAMING_PLAN, mode, 1, 5)
    dn = calculus.d(lattice(N), 1, n1.long())
    exact = (dn * dn).sum(dim=(1, 2, 3)).double() / (N * N)
    assert torch.equal(inline['WindingSquared'], exact.float())
    r = calculus.d(lattice(N), 0, phi1.double()) - 2 * math.pi * n1.double()
    torch.testing.assert_close(inline['ActionDensity'].double(),
                               0.2 * (r * r).sum(dim=(1, 2, 3)) / (N * N), rtol=1e-5, atol=0)
    a, b = (_plan_sweeps(phi, n, STREAMING_PLAN, mode, 3, 6) for _ in range(2))
    for x, y in zip(_tensors(a), _tensors(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize('N', [6, 130, 256])
def test_resident_sweeps_are_deterministic_for_a_seed(cuda, N):
    """The inline sums are reduced in a fixed order, never with float atomics."""
    phi, n = _warm(8, N, 2, 1, cuda)
    a, b = (_plan_sweeps(phi, n, sweep_plan(N), SWEEP_MODES[1], 4, 2) for _ in range(2))
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    for k in a[3]:
        assert torch.equal(a[3][k], b[3][k])


@pytest.mark.parametrize('plan', [SweepPlan('resident', 8, 32, 1024, 300_000),
                                  SweepPlan('resident', 16, 16, 1024, 81_920)])
def test_an_unschedulable_cluster_raises(cuda, plan):
    """More shared memory than a block may take, or a cluster above the
    portable 8 blocks: the launch is refused, and nothing falls back.  The
    refusal does not linger: the next kernel launch checks clean."""
    phi, n = _cold(2, 256, cuda)
    with pytest.raises(RuntimeError, match='resident'):
        _plan_sweeps(phi, n, plan, SWEEP_MODES[0], 1, 0)
    m, v = _cold_worldline(2, 8, 2, cuda)
    _worldline_sweeps(m, v, 2, 1, 0)
    _plan_sweeps(phi, n, sweep_plan(256), SWEEP_MODES[0], 1, 0)
    torch.cuda.synchronize()


def test_barrier_cycles_are_recorded_on_request(cuda):
    N = 130
    plan = sweep_plan(N)
    phi, n = _warm(3, N, 1, 2, cuda)
    cycles = torch.zeros((3 * plan.cluster, 2), dtype=torch.int64, device=cuda)
    timed = kernel_sweeps(phi, n, plan, kappa=0.4, W=1, interval_phi=1.5, interval_n=1,
                          sweeps=2, generator=torch.Generator().manual_seed(6), cycles=cycles)
    plain = _plan_sweeps(phi, n, plan, SWEEP_MODES[0], 2, 6)
    for a, b in zip(timed[:3], plain[:3]):
        assert torch.equal(a, b)
    waited, total = cycles[:, 0], cycles[:, 1]
    assert bool((waited > 0).all()) and bool((total > waited).all())


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
    with pytest.raises(ValueError, match='N >= 2'):
        _worldline_sweeps(*_cold_worldline(2, 1, 2, cuda), 2, 1, 0)
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


# -- the measurement half: observables, derived quantities and the bootstrap ----

MEASURE_RTOL = 1e-4     # float32 on the card against float64 on the CPU


def _measurement_configurations(action, N, count, seed=5):
    """The fields of ``count`` chains after a short Hammer run on the card (W=2,
    κ=0.5): configurations with the magnitudes the measurements see in use."""
    S = (villain_action if action == 'Villain' else worldline_action)(N, 0.5, 2)
    fleet = tsv.sample_fused_fleet(S, chains=count, steps=2, thin=10, worms=1, keep_fields=True,
                                   seed=seed, p_n=0.1 if action == 'Villain' else None)
    return {k: fleet.columns[k][-1] for k in S.fields}


def _relative(card, cpu):
    card, cpu = np.asarray(card, dtype=np.complex128), np.asarray(cpu, dtype=np.complex128)
    return float(np.abs(card - cpu).max() / max(np.abs(cpu).max(), 1e-300))


def d2_names(registry):
    """A registry's names but the D=4-only topological quantities."""
    return sorted(name for name, cls in registry.items()
                  if cls.__module__ != tsv.observables.topological.__name__)


@pytest.mark.parametrize('action', ['Villain', 'Worldline'])
def test_measurements_on_the_card_match_the_cpu(cuda, action):
    """Every observable, every resampled observable and every derived quantity,
    measured on the card in float32 and on the CPU in float64 from the same
    configurations and bootstrap seed, agree to 1e-4 relative."""
    S = (villain_action if action == 'Villain' else worldline_action)(6, 0.5, 2)
    cfgs = _measurement_configurations(action, 6, 48)
    values = {}
    for device in ('cuda', 'cpu'):
        e = tsv.Ensemble(S).from_configurations(tsv.Configurations(dict(cfgs)), device=device)
        boot = tsv.Bootstrap(e, draws=50, seed=3)
        values[device] = {**e.measure(),
                          **{f'Bootstrap.{n}': getattr(boot, n)
                             for n in d2_names(tsv.observables.registry)
                             + d2_names(tsv.observables.derived_registry)}}
    assert set(values['cuda']) == set(values['cpu'])
    diffs = {n: _relative(values['cuda'][n], values['cpu'][n]) for n in values['cpu']}
    bad = {n: d for n, d in diffs.items() if not d <= MEASURE_RTOL}
    assert not bad, bad


@pytest.mark.parametrize('histogram', ['Vortex_Vortex', 'Spin_Spin'])
def test_histogram_bootstrap_on_the_card_matches_the_cpu(cuda, histogram):
    """Per-chain inline histograms (as the main path keeps them) bootstrapped
    as one product on the card and on the CPU."""
    rng = np.random.default_rng(9)
    hist = rng.integers(0, 40, size=(128, 16, 16)).astype(np.float32)
    hist[:, 0, 0] += 200
    S = (villain_action if histogram == 'Vortex_Vortex' else worldline_action)(16, 0.5, 2)
    prefix = histogram.split('_')[0]
    names = [f'{histogram}_Normalized', f'{prefix}Susceptibility',
             f'{prefix}SusceptibilityScaled', f'{prefix}CriticalMoment']
    got = {}
    for device in ('cuda', 'cpu'):
        e = tsv.Ensemble(S).from_configurations(tsv.Configurations({histogram: hist}),
                                                device=device)
        boot = tsv.Bootstrap(e, draws=100, seed=7)
        got[device] = [getattr(boot, n) for n in names]
    for name, a, b in zip(names, got['cuda'], got['cpu']):
        assert _relative(a, b) <= MEASURE_RTOL, name


def test_a_card_ensemble_measures_and_bootstraps_on_the_card(cuda, monkeypatch):
    """The operands of a measurement and of the resampling product are on the
    card; nothing runs on the CPU by itself."""
    from supervillain_tpu_torch.observables.spin import Spin_Spin
    seen = []
    villain = Spin_Spin.Villain

    def spy(S, phi):
        seen.append(phi.device.type)
        return villain(S, phi)

    monkeypatch.setattr(Spin_Spin, 'Villain', staticmethod(spy))
    S = villain_action(6, 0.5, 2)
    e = tsv.Ensemble(S).from_configurations(
        tsv.Configurations(_measurement_configurations('Villain', 6, 10)))
    boot = tsv.Bootstrap(e, draws=5, seed=1)
    assert np.isfinite(boot.SpinSusceptibility).all()
    assert seen == ['cuda']
    (kw, norm), = [v for k, v in boot.__dict__.items() if isinstance(k, tuple)]
    assert kw.device.type == 'cuda' and kw.dtype == torch.float32


def test_a_card_fleet_measures_on_the_card(cuda):
    S = worldline_action(8, 0.5, 2)
    fleet = tsv.sample_fused_fleet(S, chains=16, steps=3, thin=2, worms=1, keep_fields=True,
                                   seed=4)
    e = fleet.pooled_ensemble(1)
    assert torch.device(e.device).type == 'cuda'
    boot = tsv.Bootstrap(e, draws=20, seed=0)
    for name in ('SpinSusceptibility', 'VortexCriticalMoment', 'Action_Action'):
        assert np.isfinite(getattr(boot, name)).all()


# -- the general generator path on the card ------------------------------------------

def _refuse_cuda(monkeypatch, module, name):
    """Make ``module.name`` (a plain twin) raise when it is handed a CUDA tensor."""
    plain = getattr(module, name)

    def guard(*args, **kwargs):
        if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
            raise AssertionError(f'{name} ran on a CUDA tensor')
        return plain(*args, **kwargs)

    monkeypatch.setattr(module, name, guard)


def test_eager_steps_launch_b1_b2_b5_and_no_plain_twin(cuda, monkeypatch):
    from supervillain_tpu_torch.generators import villain as gv, worldline as gw
    from supervillain_tpu_torch.ops import sweep, worm, worldline_worm
    for module, name in ((sweep, 'plain_sweeps'), (worm, 'plain_worms'),
                         (worldline_worm, 'plain_worldline_worms')):
        _refuse_cuda(monkeypatch, module, name)
    counters = (neighborhood_sweeps, classic_worms, worldline_worms)
    for f in counters:
        f.launches = 0
    SV = villain_action(8, 0.5, 2)
    SI = villain_action(8, 0.5, float('inf'))
    SW = worldline_action(8, 0.5, 2)
    e = tsv.Ensemble(SV).generate(3, tsv.Sequentially([gv.NeighborhoodUpdate(SV),
                                                       gv.ClassicWorm(SV, max_moves=512)]))
    tsv.Ensemble(SI).generate(2, gv.ExactNeighborhoodUpdate(SI))
    w = tsv.Ensemble(SW).generate(3, gw.Hammer(SW, fleet=True))
    assert [f.launches for f in counters] == [5, 3, 3]
    assert all(SV.valid({'n': torch.as_tensor(n)}) for n in e.n)
    assert all(SW.valid({'m': torch.as_tensor(m)}) for m in w.m)
    np.testing.assert_array_equal(e.Worm_Length, e.Vortex_Vortex.sum(axis=(1, 2)))


@pytest.mark.parametrize('action,W', [('Villain', 1), ('Villain', 2), ('Worldline', 2)])
def test_hammer_fleet_runs_on_the_card(cuda, action, W):
    from supervillain_tpu_torch.generators import villain as gv, worldline as gw
    S = (villain_action if action == 'Villain' else worldline_action)(8, 0.5, W)
    G = (gv if action == 'Villain' else gw).Hammer(S, fleet=True)
    fleet = tsv.sample_fleet(S, G, chains=16, steps=3, thin=2, seed=2)
    for k, v in fleet.columns.items():
        assert v.shape[:2] == (3, 16) and np.isfinite(v).all(), k
    assert fleet.stats['ClassicWorm']['sweeps'] > 0
    assert np.isfinite(fleet.pooled_ensemble(1).ActionDensity).all()


# -- odd N: four colors, the color-table passes of B1 and B4 -------------------

ODD_N = [3, 5, 7, 11]


@pytest.mark.parametrize('W', [1, 2, float('inf')])
@pytest.mark.parametrize('N', ODD_N)
def test_odd_n_kernels_repeat_their_plain_versions_on_the_same_draws(cuda, N, W):
    """At odd N the sweep kernel (table plan) and the worm kernel repeat their
    plain versions fed the kernels' Philox draws, which number a sweep's
    passes n_colors·sweep + color; dn ≡ 0 (mod W) and, at W=∞, dn = 0 bitwise."""
    assert sweep_plan(N).regime == 'table'
    B, kappa = 64, 0.4
    phi = (torch.rand((B, 1, N, N), generator=torch.Generator().manual_seed(1)) - 0.5).to(cuda)
    _, n = _cold(B, N, cuda)
    seed = kernels.seed_from(torch.Generator().manual_seed(5))
    got = _sweeps(phi, n, W, 6, 5)
    draws = KernelSweepDraws(seed, B=B, N=N, interval_phi=math.pi, interval_n=1, p_n=0.3,
                             zmode=W == float('inf'), fdt=torch.float32, idt=torch.int32,
                             device=cuda)
    want = plain_sweeps(phi, n, kappa=kappa, W=W, sweeps=6, draws=draws)
    assert draws.passes == 6 * lattice(N).n_colors
    assert float((got[0] != want[0]).float().mean()) <= 1e-3
    assert float((got[1] != want[1]).float().mean()) <= 1e-3
    assert float(got[2].sum()) > 0
    dn = calculus.d(lattice(N), 1, got[1])
    assert bool(((dn == 0) if W == float('inf') else (dn % W == 0)).all())

    cap = None if W == 1 else 16
    worm = classic_worms(got[0], got[1], kappa=kappa, W=W, worms=4, max_worm_moves=cap,
                         generator=torch.Generator().manual_seed(6))
    want = plain_worms(got[0], got[1], kappa=kappa, W=W, worms=4, max_worm_moves=cap,
                       draws=KernelWormDraws(kernels.seed_from(torch.Generator().manual_seed(6)),
                                             B=B, N=N, device=cuda))
    same = [(a == b).reshape(B, -1).all(dim=1) for a, b in zip(worm, want)]
    assert float(torch.stack(same).all(dim=0).float().mean()) >= 1 - 1 / B


@pytest.mark.parametrize('W', [1, 2, float('inf')])
@pytest.mark.parametrize('N', ODD_N)
def test_odd_n_worldline_kernels_repeat_their_plain_versions_on_the_same_draws(cuda, N, W):
    """At odd N the Worldline sweep kernel (public layout, color table) and worm
    kernel repeat their plain versions on the kernels' draws; δm = 0 bitwise."""
    B, kappa = 64, 0.5
    m, v = _cold_worldline(B, N, W, cuda)
    m, v, _, _ = _worldline_sweeps(m, v, W, 20, 4)
    got = _worldline_sweeps(m, v, W, 6, 5)
    draws = _worldline_sweep_draws(5, B, N, W, cuda)
    want = plain_worldline_sweeps(m, v, kappa=kappa, W=W, sweeps=6, draws=draws)
    assert draws.passes == 6 * (2 * lattice(N).n_colors + 2)
    assert float((got[0] != want[0]).float().mean()) <= 1e-3
    assert float((got[1] != want[1]).float().mean()) <= 1e-3
    assert bool((calculus.delta(lattice(N), 1, got[0]) == 0).all())
    torch.testing.assert_close(got[3]['ActionDensity'], want[3]['ActionDensity'],
                               rtol=1e-4, atol=0)
    worm = worldline_worms(got[0], got[1], kappa=kappa, W=W, worms=4, max_worm_moves=64,
                           generator=torch.Generator().manual_seed(6))
    want = plain_worldline_worms(
        got[0], got[1], kappa=kappa, W=W, worms=4, max_worm_moves=64,
        draws=KernelWorldlineWormDraws(kernels.seed_from(torch.Generator().manual_seed(6)),
                                       B=B, N=N, device=cuda))
    same = [(a == b).reshape(B, -1).all(dim=1) for a, b in zip(worm, want)]
    assert float(torch.stack(same).all(dim=0).float().mean()) >= 1 - 1 / B
    assert bool((calculus.delta(lattice(N), 1, worm[0]) == 0).all())


@pytest.mark.parametrize('N', [6, 256])
def test_table_plan_at_even_n_agrees_with_the_kernels_plan_bit_for_bit(cuda, N):
    """The color-table passes, run at an even N on its two-color table, give the
    φ, n and accepted counts of the resident regime bit for bit."""
    for mode in SWEEP_MODES:
        phi, n = _warm(4, N, mode[0], 7, cuda)
        planned = _plan_sweeps(phi, n, sweep_plan(N), mode, 3, 11)
        table = _plan_sweeps(phi, n, TABLE_PLAN, mode, 3, 11)
        for a, b in zip(planned[:3], table[:3]):
            assert torch.equal(a, b)


@pytest.mark.parametrize('N', [16, 15, 1024, 311])
def test_a_shard_with_chain0_gives_its_rows_of_the_whole_call(cuda, N):
    """Each kernel on 12 chains, and on the shards [0, 5) and [5, 12) with
    chain0 = 0 and 5 and the same seed: every output row equal bit for bit
    (at N = 1024 and 311 the sweeps stream, their inline sums in bands)."""
    B, cut = 12, 5
    g = torch.Generator().manual_seed(N)
    phi = ((torch.rand((B, 1, N, N), generator=g) - 0.5) * 2 * math.pi).to(cuda)
    n = torch.zeros((B, 2, N, N), dtype=torch.int32, device=cuda)
    v = torch.randint(-2, 3, (B, 1, N, N), generator=g, dtype=torch.int32).to(cuda)
    calls = [
        (lambda a, b, **k: neighborhood_sweeps(a, b, kappa=0.5, W=2, interval_phi=math.pi,
                                               interval_n=1, sweeps=3, **k), (phi, n)),
        (lambda a, b, **k: classic_worms(a, b, kappa=0.5, W=1, worms=2, max_worm_moves=256, **k),
         (phi, n)),
        (lambda a, b, **k: worldline_sweeps(a, b, kappa=0.5, W=2, sweeps=3, **k), (n, v)),
        (lambda a, b, **k: worldline_worms(a, b, kappa=0.5, W=2, worms=2, max_worm_moves=256,
                                           **k), (n, v)),
    ]
    for fn, (a, b) in calls:
        whole = fn(a, b, generator=torch.Generator().manual_seed(3))
        parts = [fn(a[lo:hi], b[lo:hi], generator=torch.Generator().manual_seed(3), chain0=lo)
                 for lo, hi in ((0, cut), (cut, B))]
        for w, p0, p1 in zip(*(_tensors(out) for out in (whole, *parts))):
            assert torch.equal(w[:cut], p0) and torch.equal(w[cut:], p1)


def _tensors(out):
    """A kernel wrapper's outputs as a list of tensors (inline dicts by key)."""
    return [t for x in out for t in ([x[k] for k in sorted(x)] if isinstance(x, dict) else [x])]


# -- K1 (the ChunkedWorm) and K2 (the Worldline worm at D >= 3) ---------------

@pytest.mark.parametrize('N', [5, 8])
def test_chunked_worm_kernel_repeats_its_plain_twin(cuda, N):
    """K1 against its plain twin on K1's Philox draws, and its shards (chain0)
    against the whole call bit for bit."""
    from supervillain_tpu_torch.ops.worm import (KernelChunkedWormDraws, chunked_worms,
                                                 plain_chunked_worms)
    B, T = 64, 64
    g = torch.Generator().manual_seed(8)
    phi = ((torch.rand((B, 1, N, N), generator=g) - 0.5) * 2 * math.pi).to(cuda)
    n = torch.randint(-1, 2, (B, 2, N, N), generator=g, dtype=torch.int32).to(cuda)
    worm = torch.cat([torch.randint(0, N, (B, 4), generator=g),
                      2 * torch.randint(0, 2, (B, 1), generator=g) - 1], dim=1).int().to(cuda)
    got = chunked_worms(phi, n, worm, kappa=0.1, moves=T, generator=torch.Generator().manual_seed(9))
    seed = kernels.seed_from(torch.Generator().manual_seed(9))
    want = plain_chunked_worms(phi, n, worm, kappa=0.1, moves=T,
                               draws=KernelChunkedWormDraws(seed, B=B, N=N, device=cuda))
    same = [(a == b).reshape(B, -1).all(dim=1) for a, b in zip(got, want)]
    assert float(torch.stack(same).all(dim=0).float().mean()) >= 1 - 1 / B
    part = chunked_worms(phi[16:], n[16:], worm[16:], kappa=0.1, moves=T,
                         generator=torch.Generator().manual_seed(9), chain0=16)
    for a, b in zip(got, part):
        assert torch.equal(a[16:], b)


@pytest.mark.parametrize('D,W', [(3, 1), (3, 2), (4, float('inf'))])
def test_general_worldline_worm_kernel_repeats_its_plain_twin(cuda, D, W):
    """K2 against its plain twin on the stream of KernelWorldlineWormDraws
    with D (capped), δm = 0 after the call, and its shards bit for bit."""
    from supervillain_tpu_torch.ops.worldline_worm import worldline_worms_general
    B, N = 32, 4
    S = worldline_action(N, 0.3, W, D=D)
    cold = S.initial(cuda)
    m, v = (x.expand((B,) + x.shape).contiguous() for x in (cold['m'], cold['v']))
    common = dict(kappa=0.3, W=W, worms=2, max_worm_moves=256)
    got = worldline_worms_general(m, v, generator=torch.Generator().manual_seed(3), **common)
    seed = kernels.seed_from(torch.Generator().manual_seed(3))
    want = plain_worldline_worms(m, v, draws=KernelWorldlineWormDraws(
        seed, B=B, N=N, device=cuda, D=D), **common)
    same = [(a == b).reshape(B, -1).all(dim=1) for a, b in zip(got, want)]
    assert float(torch.stack(same).all(dim=0).float().mean()) >= 1 - 1 / B
    assert bool((calculus.delta(S.Lattice, 1, got[0]) == 0).all())
    part = worldline_worms_general(m[8:], v[8:], generator=torch.Generator().manual_seed(3),
                                   chain0=8, **common)
    for a, b in zip(got, part):
        assert torch.equal(a[8:], b)
