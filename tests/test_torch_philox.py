"""The port's PyTorch Philox-4x32-10 and the kernels' draw sources built on it.

The generator must match the published known-answer vectors bit for bit (the
CUDA kernels run the same rounds); a chain's draws must not depend on how many
chains share the call, as in the kernels, whose counters carry the chain index."""

import math

import numpy as np
import pytest
import torch

from supervillain_tpu_torch.interop import villain_action
from supervillain_tpu_torch.ops.philox import philox4x32_10, u24
from supervillain_tpu_torch.ops.sweep import KernelSweepDraws, plain_sweeps
from supervillain_tpu_torch.ops.worm import KernelWormDraws, plain_worms

# Random123's known-answer vectors for philox4x32 with 10 rounds.
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2, (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize('counter,key,want', KAT)
def test_philox_matches_known_answers(counter, key, want):
    assert tuple(int(w) for w in philox4x32_10(counter, key)) == want


def test_philox_broadcasts_and_u24_is_exact():
    words = philox4x32_10((torch.arange(5), 3, 0, 1), (11, 12))
    assert all(w.shape == (5,) and w.dtype == torch.int64 for w in words)
    assert all(int(w.min()) >= 0 and int(w.max()) < 2 ** 32 for w in words)
    for i in range(5):
        assert int(philox4x32_10((i, 3, 0, 1), (11, 12))[2]) == int(words[2][i])
    u = u24(torch.tensor([0, 255, 256, 2 ** 32 - 1]))
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(), [0, 0, 2.0 ** -24, 1 - 2.0 ** -24])


@pytest.mark.parametrize('W,interval,p', [(1, 1, None), (2, 2, 0.3), (float('inf'), 1, None)])
def test_kernel_draws_do_not_depend_on_the_batch(W, interval, p):
    """Chain c's trajectory under the kernels' draws is the same in a batch of
    3 and of 5, and the plain version keeps the constraint under them."""
    N, kappa = 6, 0.3
    S = villain_action(N, kappa, W)
    out = []
    for B in (3, 5):
        phi = torch.zeros((B, 1, N, N), dtype=torch.float32)
        n = torch.zeros((B, 2, N, N), dtype=torch.int32)
        draws = KernelSweepDraws(2 ** 40 + 17, B=B, N=N, interval_phi=math.pi,
                                 interval_n=interval, p_n=p, zmode=W == float('inf'),
                                 fdt=torch.float32, idt=torch.int32, device='cpu')
        phi, n, accepted, _ = plain_sweeps(phi, n, kappa=kappa, W=W, sweeps=4, draws=draws)
        assert draws.passes == 8
        n, hist, length, truncated = plain_worms(
            phi, n, kappa=kappa, W=W, worms=3, max_worm_moves=6,
            draws=KernelWormDraws(5, B=B, N=N, device='cpu'))
        assert torch.equal(length, hist.sum(dim=(1, 2)))
        assert all(S.valid({'n': n[b]}) for b in range(B))
        out.append((phi[:3], n[:3], accepted[:3], hist[:3], truncated[:3]))
    assert float(out[0][2].sum()) > 0
    for a, b in zip(*out):
        assert torch.equal(a, b)
