"""Tests of the CUDA kernels themselves; they need an NVIDIA GPU and skip without one.

On a machine with a card (which need not have JAX):

    python -m pytest --noconftest -o addopts='' -m cuda tests/test_torch_cuda.py -q
"""

import math

import pytest
import torch

from supervillain_tpu_torch.interop import villain_action
from supervillain_tpu_torch.ops import calculus, kernels
from supervillain_tpu_torch.ops.hammer import hammer_sweeps
from supervillain_tpu_torch.ops.sweep import (KernelSweepDraws, lattice, neighborhood_sweeps,
                                              plain_sweeps)
from supervillain_tpu_torch.ops.worm import KernelWormDraws, classic_worms, plain_worms

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
