"""Worldline classic (site) worms: the CUDA kernel and its plain PyTorch twin.

Counterpart of :func:`supervillain_tpu.ops.pallas_worldline_hammer.worldline_worms`.
:func:`worldline_worms` dispatches by device: a CPU batch runs
:func:`plain_worldline_worms` on the kernel's own Philox stream, a CUDA batch
runs the kernel of ``csrc/worldline_worm.cu``, and any other device raises.

:func:`worldline_worms_general` (K2) dispatches the same way at any D, the
D >= 3 worm's path: a CPU batch runs :func:`plain_worldline_worms` on the
stream of :class:`KernelWorldlineWormDraws` with ``D``, a CUDA batch runs the
kernel of ``csrc/worldline_worm_general.cu`` (which replays that stream draw
for draw), and any other device raises.

The plain version is the move rule of
:class:`supervillain_tpu.generators.worldline.ClassicWorm` in any dimension D,
advancing all chains one move per iteration (a chain whose worm has closed
stops drawing), with the draws coming from a draw source: the kernels' Philox
stream (:class:`KernelWorldlineWormDraws`), which both dispatchers draw on the
CPU, a ``torch.Generator``
(:class:`WorldlineWormDraws`), or the JAX package's own (tests).  The worm
changes only m; the crossed link's residual is m − δv/_W with δv/_W fixed for
the call.
"""

from __future__ import annotations

import torch

from . import calculus as calc
from . import kernels, philox, shard
from .sweep import lattice_of
from .worldline import inverse_w
from ..device import float_dtype_of


def close_probability(D):
    """Probability of the close move when head == tail: 1/(2D+1)."""
    return 1 / (2 * D + 1)


#: The close probability in D=2, where the kernel runs.
CLOSE = close_probability(2)


class WorldlineWormDraws:
    """Draw source of :func:`plain_worldline_worms` from a ``torch.Generator``.

    ``start()`` gives each chain's orientation (B,) and tail (B, D); ``move()``
    each chain's close uniform, move choice in 0..2D−1 and Metropolis uniform
    (B,), one call per move."""

    def __init__(self, generator, *, B, N, fdt, device, D=2):
        self.generator, self.B, self.N, self.fdt, self.device = generator, B, N, fdt, device
        self.D = D

    def start(self):
        g, B, dev = self.generator, self.B, self.device
        orientation = 2 * torch.randint(0, 2, (B,), generator=g, device=dev) - 1
        return orientation, torch.randint(0, self.N, (B, self.D), generator=g, device=dev)

    def move(self):
        g, B, dev = self.generator, self.B, self.device
        u = torch.rand((2, B), generator=g, dtype=self.fdt, device=dev)
        return u[0], torch.randint(0, 2 * self.D, (B,), generator=g, device=dev), u[1]


class KernelWorldlineWormDraws:
    """The draws of one CUDA worldline-worm call seeded with ``seed``, as a draw
    source of :func:`plain_worldline_worms`: Philox-4x32-10 keyed by the seed's
    Worldline key and countered by (chain, worm, 0, 2) for a worm's start and
    (chain, worm, move, odd) for each move, the chain word being ``chain0`` +
    the chain's index in the batch, with the kernel's conversions
    (``csrc/worldline_worm.cu``).  Moves are drawn ``BLOCK`` at a time: one
    Philox evaluation per block instead of per move keeps a replay of long worms
    affordable.  At D >= 3 (K2, ``csrc/worldline_worm_general.cu``) the same
    stream goes on: the tail's coordinates past the third from (chain, worm, j,
    2), j = 1, 2, ..., and the move choice as the word modulo 2D (B5's ``& 3``
    at D=2)."""

    BLOCK = 256

    def __init__(self, seed, *, B, N, device, chain0=0, D=2):
        self.key = philox.worldline_key(seed)
        self.N, self.D, self.device = N, D, device
        self.chain = chain0 + torch.arange(B, device=device)
        self.worm, self.moves = -1, 0

    def _site(self, word):
        return (word * self.N) >> 32

    def start(self):
        self.worm += 1
        self.moves = 0
        s = philox.philox4x32_10((self.chain, self.worm, 0, 2), self.key, self.device)
        orientation = torch.where((s[0] >> 31) == 1, 1, -1)
        words = list(s[1:])
        for j in range(1, 1 + max(0, -(-(self.D - 3) // 4))):
            words += philox.philox4x32_10((self.chain, self.worm, j, 2), self.key, self.device)
        return orientation, torch.stack([self._site(w) for w in words[:self.D]], dim=-1)

    def move(self):
        k = self.moves % self.BLOCK
        if k == 0:
            t = self.moves + torch.arange(self.BLOCK, device=self.device)
            w = philox.philox4x32_10((self.chain[:, None], self.worm, t & philox.MASK,
                                      2 * (t >> 32) + 1), self.key, self.device)
            self._buffer = (philox.u24(w[0]), w[1] % (2 * self.D), philox.u24(w[2]))
        self.moves += 1
        return tuple(b[:, k] for b in self._buffer)


def plain_worldline_worms(m, v, *, kappa, W, worms, max_worm_moves, draws):
    """``worms`` worldline worms per chain in plain PyTorch, on any device and
    in any D: the head moves ±e_k (choices 0..D−1 forward, D..2D−1 back), and
    closes with probability 1/(2D+1) at the tail.

    A worm still open after ``max_worm_moves`` moves is rolled back (an open
    worm breaks δm = 0 at every W).  Returns ``(m, hist, length, truncated)``
    like :func:`worldline_worms`."""
    L = lattice_of(m)
    B, N, D = m.shape[0], L.N, L.D
    dev, fdt = m.device, float_dtype_of(v)
    m = m.clone()
    dvw = calc.delta(L, 2, v).to(fdt) * inverse_w(W)
    eye = torch.eye(D, dtype=torch.int64, device=dev)
    moves = torch.cat([eye, -eye])
    axis = torch.arange(2 * D, device=dev) % D
    sign = torch.cat([torch.ones(D, dtype=m.dtype, device=dev),
                      -torch.ones(D, dtype=m.dtype, device=dev)])
    close = close_probability(D)
    chains = torch.arange(B, device=dev)
    hist = torch.zeros((B,) + L.dims, dtype=fdt, device=dev)
    truncated = torch.zeros(B, dtype=fdt, device=dev)
    rollback = max_worm_moves is not None

    for _ in range(worms):
        orientation, tail = draws.start()
        head = tail
        change_m = orientation[:, None].to(m.dtype) * sign
        start = m.clone() if rollback else None
        open_ = torch.ones(B, dtype=torch.bool, device=dev)
        t = 0
        while (max_worm_moves is None or t < max_worm_moves) and bool(open_.any()):
            u_close, choice, u_accept = draws.move()
            close_now = (head == tail).all(dim=-1) & (u_close < close)
            next_head = torch.remainder(head + moves[choice], N)
            lpos = torch.where((choice < D)[:, None], head, next_head)
            at = (chains, axis[choice], *lpos.unbind(-1))
            link = m[at].to(fdt) - dvw[at]
            dm = change_m[chains, choice]
            dmf = dm.to(fdt)
            dS = (0.5 / kappa) * dmf * (2 * link + dmf)
            accept = (u_accept < torch.clamp(torch.exp(-dS), max=1.0)) & ~close_now & open_

            m[at] = m[at] + torch.where(accept, dm, 0)
            head = torch.where(accept[:, None], next_head, head)
            disp = torch.remainder(head - tail, N)
            tally = (chains, *disp.unbind(-1))
            hist[tally] = hist[tally] + (open_ & ~close_now).to(fdt)
            open_ = open_ & ~close_now
            t += 1
        if rollback:
            m = torch.where(open_.reshape((B,) + (1,) * (D + 1)), start, m)
            truncated = truncated + open_.to(fdt)
    return m, hist, hist.sum(dim=tuple(range(1, D + 1))), truncated


def worldline_worms(m, v, *, kappa, W, worms=1, max_worm_moves=None, generator, chain0=None):
    """Run ``worms`` whole worldline worms per chain.

    Parameters
    ----------
    m: (B, 2, N, N) int; v: (B, 1, N, N) int or float (W = inf) — read only
    max_worm_moves: per-worm move cap (exact rollback of an unclosed worm) or None
    generator: ``torch.Generator`` or a shard's :class:`.shard.ShardGenerator`
        — the kernel seed, on the CPU (:class:`KernelWorldlineWormDraws`) as on a GPU
    chain0: the global index of the batch's first chain, which the kernel's
        stream counts from (default: the generator's, 0 for a ``torch.Generator``)

    Returns
    -------
    (m, hist, length, truncated): updated links with δm = 0, the summed inline
    ``Spin_Spin`` histogram (B, N, N), the total worm length (B,) and the
    number of truncated (rolled back) worms (B,).
    """
    chain0 = shard.resolve_chain0(generator, chain0, m.device)
    if m.device.type == 'cpu':
        draws = KernelWorldlineWormDraws(kernels.seed_from(generator), B=m.shape[0],
                                         N=m.shape[-1], device=m.device, chain0=chain0)
        return plain_worldline_worms(m, v, kappa=kappa, W=W, worms=worms,
                                     max_worm_moves=max_worm_moves, draws=draws)
    if m.device.type != 'cuda':
        raise ValueError(f'worldline_worms runs on the CPU or a CUDA device, not {m.device}')

    B, N = kernels.require_worldline_fields(m, v, W)
    cap = -1 if max_worm_moves is None else int(max_worm_moves)
    if cap >= 2 ** 31:
        raise ValueError(f'max_worm_moves must be below 2**31, got {cap}')
    lib = kernels.library()
    m_out = torch.empty_like(m)
    packed = torch.empty((B, N, N, 2, 2), dtype=torch.int32, device=m.device)
    hist = torch.empty((B, N, N), dtype=torch.float32, device=m.device)
    stat = torch.empty((B, 2), dtype=torch.float32, device=m.device)
    log_words = (cap + 15) // 16 if cap >= 0 else 0
    log = torch.empty((B, log_words), dtype=torch.int32, device=m.device) if cap >= 0 else None
    entry = lib.sv_worldline_worms_winf if W == float('inf') else lib.sv_worldline_worms
    seed = kernels.seed_from(generator)
    with torch.cuda.device(m.device):
        code = entry(m.data_ptr(), v.data_ptr(), m_out.data_ptr(), packed.data_ptr(),
                     hist.data_ptr(), stat.data_ptr(), None if log is None else log.data_ptr(),
                     log_words, B, N, float(0.5 / kappa), float(inverse_w(W)), int(worms), cap,
                     seed, kernels.chain_word(chain0, B), kernels.stream_handle(m.device))
    kernels.check(code, 'worldline_worms')
    worldline_worms.launches += 1
    return m_out, hist, stat[:, 0], stat[:, 1]


#: Calls that launched the CUDA kernel (the CPU path never counts).
worldline_worms.launches = 0


def worldline_worms_general(m, v, *, kappa, W, worms=1, max_worm_moves=None, generator,
                            chain0=None):
    """Run ``worms`` whole worldline worms per chain in any dimension D (K2).

    Parameters
    ----------
    m: (B, D, N, ..., N) int; v: (B, D(D−1)/2, N, ..., N) int or float (W = inf)
        — read only
    max_worm_moves: per-worm move cap (exact rollback of an unclosed worm) or None
    generator: ``torch.Generator`` or a shard's :class:`.shard.ShardGenerator`
        — the kernel seed, on the CPU (:class:`KernelWorldlineWormDraws` with
        ``D``) as on a GPU
    chain0: the global index of the batch's first chain, which the kernel's
        stream counts from (default: the generator's, 0 for a ``torch.Generator``)

    Returns
    -------
    (m, hist, length, truncated): updated links with δm = 0, the summed inline
    ``Spin_Spin`` histogram (B, N, ..., N), the total worm length (B,) and the
    number of truncated (rolled back) worms (B,).
    """
    L = lattice_of(m)
    B, N, D = m.shape[0], L.N, L.D
    chain0 = shard.resolve_chain0(generator, chain0, m.device)
    if m.device.type == 'cpu':
        draws = KernelWorldlineWormDraws(kernels.seed_from(generator), B=B, N=N,
                                         device=m.device, chain0=chain0, D=D)
        return plain_worldline_worms(m, v, kappa=kappa, W=W, worms=worms,
                                     max_worm_moves=max_worm_moves, draws=draws)
    if m.device.type != 'cuda':
        raise ValueError(f'worldline_worms_general runs on the CPU or a CUDA device, not {m.device}')

    vdt = torch.float32 if W == float('inf') else torch.int32
    components = D * (D - 1) // 2
    if v.device != m.device or (m.dtype, v.dtype) != (torch.int32, vdt):
        raise TypeError(f'K2 needs int32 m and {vdt} v on one CUDA device, got {m.dtype} on '
                        f'{m.device} and {v.dtype} on {v.device}')
    if tuple(v.shape) != (B, components) + L.dims or m.shape[1] != D or N < 2:
        raise ValueError(f'K2 needs m (B, {D}) + {L.dims} and v (B, {components}) + {L.dims} '
                         f'with N >= 2, got {tuple(m.shape)} and {tuple(v.shape)}')
    V = N ** D
    if B * D * V >= 2 ** 31:
        raise ValueError(f'{B} chains of N={N}, D={D} exceed the kernel\'s 32-bit link indexing')
    cap = -1 if max_worm_moves is None else int(max_worm_moves)
    if cap >= 2 ** 31:
        raise ValueError(f'max_worm_moves must be below 2**31, got {cap}')
    m = m.contiguous()
    dvw = (calc.delta(L, 2, v).to(torch.float32) * inverse_w(W)).contiguous()
    bits = max(1, (2 * D - 1).bit_length())
    log_words = -(-cap // (32 // bits)) if cap >= 0 else 0
    lib = kernels.library()
    m_out = torch.empty_like(m)
    hist = torch.empty((B,) + L.dims, dtype=torch.float32, device=m.device)
    stat = torch.empty((B, 2), dtype=torch.float32, device=m.device)
    log = torch.empty((B, log_words), dtype=torch.int32, device=m.device) if cap >= 0 else None
    seed = kernels.seed_from(generator)
    with torch.cuda.device(m.device):
        code = lib.sv_worldline_worms_general(
            m.data_ptr(), dvw.data_ptr(), m_out.data_ptr(), hist.data_ptr(), stat.data_ptr(),
            None if log is None else log.data_ptr(), log_words, B, D, N, V, float(0.5 / kappa),
            float(close_probability(D)), int(worms), cap, bits, seed,
            kernels.chain_word(chain0, B), kernels.stream_handle(m.device))
    kernels.check(code, 'worldline_worms_general')
    worldline_worms_general.launches += 1
    return m_out, hist, stat[:, 0], stat[:, 1]


#: Calls that launched the CUDA kernel (the CPU path never counts).
worldline_worms_general.launches = 0
