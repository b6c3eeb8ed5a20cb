"""Philox-4x32-10 in PyTorch: the kernels' random stream for the plain versions.

Bit for bit the generator of ``csrc/philox.cuh`` (Salmon et al., SC'11).
32-bit words are held in int64 tensors; the 32x32-bit products are split into
16-bit halves so that no intermediate leaves the int64 range.  Fed through the
draw sources :class:`..sweep.KernelSweepDraws`, :class:`..worm.KernelWormDraws`,
:class:`..worm.KernelChunkedWormDraws` and their Worldline counterparts, it lets the plain versions repeat a kernel call
draw for draw, on any device.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85

#: XORed into a kernel seed to key the Worldline kernels (``csrc/philox.cuh``),
#: so that a Villain and a Worldline call with one seed never share draws.
WORLDLINE_SALT = 0x243F6A8885A308D3
#: XORed into a kernel seed to key the ChunkedWorm kernel (``csrc/worm.cu``),
#: so that its draws differ from the classic worm's for the same seed.
CHUNKED_SALT = 0x13198A2E03707344


def _mulhilo(m: int, x):
    """High and low 32-bit words of ``m * x`` (m < 2^32, x in [0, 2^32))."""
    lo = m * (x & 0xFFFF)
    hi = m * (x >> 16)
    low = lo + ((hi & 0xFFFF) << 16)
    return (hi >> 16) + (low >> 32), low & MASK


def key_of(seed: int):
    """The (low, high) 32-bit key words of a 64-bit kernel seed."""
    return seed & MASK, (seed >> 32) & MASK


def worldline_key(seed: int):
    """The key words of the Worldline kernels for a 64-bit kernel seed."""
    return key_of(seed ^ WORLDLINE_SALT)


def chunked_key(seed: int):
    """The key words of the ChunkedWorm kernel for a 64-bit kernel seed."""
    return key_of(seed ^ CHUNKED_SALT)


def philox4x32_10(counter, key, device='cpu'):
    """Four int64 tensors of 32-bit words for the counter words ``counter``
    (four tensors or ints, broadcast together) and the key pair ``key``."""
    c = torch.broadcast_tensors(*(torch.as_tensor(w, dtype=torch.int64, device=device)
                                  for w in counter))
    c0, c1, c2, c3 = c
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & MASK, (k1 + _W1) & MASK
    return c0, c1, c2, c3


def u24(word):
    """Uniform in [0, 1) from the top 24 bits of a word, in float32 (exact)."""
    return (word >> 8).to(torch.float32) * (1.0 / 16777216.0)
