"""Philox-4x32-10 (Salmon et al., SC'11) in plain PyTorch and NumPy.

The random stream that the program's CUDA kernels draw from, written out again
so that the reference can replay a kernel call draw for draw: a frozen copy
of the counter-based generator, with the kernels' key salts and their
conversion of a 32-bit word to a float32 uniform.  32-bit words are held in
int64 tensors (PyTorch) or uint64 arrays (NumPy); a 32x32-bit product is split
into 16-bit halves in PyTorch so that no intermediate leaves the int64 range.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85

#: XORed into a kernel seed to key the Worldline kernels.
WORLDLINE_SALT = 0x243F6A8885A308D3
#: XORed into a kernel seed to key the chunked worm's kernel.
CHUNKED_SALT = 0x13198A2E03707344


def key_of(seed: int):
    """The (low, high) 32-bit key words of a 64-bit kernel seed."""
    return seed & MASK, (seed >> 32) & MASK


def worldline_key(seed: int):
    return key_of(seed ^ WORLDLINE_SALT)


def _mulhilo(m: int, x):
    lo = m * (x & 0xFFFF)
    hi = m * (x >> 16)
    low = lo + ((hi & 0xFFFF) << 16)
    return (hi >> 16) + (low >> 32), low & MASK


def philox(counter, key, device='cpu'):
    """Four int64 tensors of 32-bit words for the counter words ``counter``
    (four tensors or ints, broadcast together) under the key pair ``key``."""
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(w, dtype=torch.int64, device=device) for w in counter))
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & MASK, (k1 + _W1) & MASK
    return c0, c1, c2, c3


def philox_np(counter, key):
    """:func:`philox` in NumPy: four uint64 arrays of 32-bit words."""
    c0, c1, c2, c3 = np.broadcast_arrays(*(np.asarray(w, dtype=np.uint64) for w in counter))
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    mask, shift = np.uint64(MASK), np.uint64(32)
    m0, m1 = np.uint64(_M0), np.uint64(_M1)
    for _ in range(10):
        p0, p1 = m0 * c0, m1 * c2          # exact: both factors are below 2**32
        c0, c1, c2, c3 = (p1 >> shift) ^ c1 ^ k0, p1 & mask, (p0 >> shift) ^ c3 ^ k1, p0 & mask
        k0, k1 = (k0 + np.uint64(_W0)) & mask, (k1 + np.uint64(_W1)) & mask
    return c0, c1, c2, c3


def u24(word):
    """Uniform in [0, 1) from the top 24 bits of a word, in float32 (exact)."""
    return (word >> 8).to(torch.float32) * (1.0 / 16777216.0)


def u24_np(word):
    """:func:`u24` of uint64 words as exact Python floats (float64 arrays)."""
    return (word >> np.uint64(8)).astype(np.float64) * (1.0 / 16777216.0)
