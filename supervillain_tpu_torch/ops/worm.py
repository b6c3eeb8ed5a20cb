"""Classic (plaquette) worms: the CUDA kernels and their plain PyTorch twins.

Counterpart of :func:`supervillain_tpu.ops.pallas_worm.classic_worms`.
:func:`classic_worms` dispatches by device: a CPU batch runs
:func:`plain_worms` on the kernel's own Philox stream, a CUDA batch runs the
kernel of ``csrc/worm.cu``, and any other device raises.

:func:`chunked_worms` (K1) does the same for the micro-moves of
:class:`supervillain_tpu.generators.villain.ChunkedWorm` (its ``lax.fori_loop``),
with :func:`plain_chunked_worms` as its twin and
:class:`KernelChunkedWormDraws` as the kernel's draw source.

The plain version is the move rule of
:class:`supervillain_tpu.generators.villain.ClassicWorm`, advancing all chains
one move per iteration (a chain that has closed stops drawing), with the draws
coming from a draw source: the kernel's Philox stream (:class:`KernelWormDraws`),
which :func:`classic_worms` draws on the CPU, a ``torch.Generator``
(:class:`WormDraws`), or the JAX package's own (tests).
"""

from __future__ import annotations

import numpy as np
import torch

from . import calculus as calc
from . import kernels, philox, shard
from .sweep import lattice

TWO_PI = 2 * np.pi

# Neighboring-plaquette moves (east, north, west, south) in (t, x), the link
# each move crosses, and the constraint-restoring Δn sign.
_MOVES = ((0, -1), (1, 0), (0, 1), (-1, 0))
_LINK_DIR = (0, 1, 0, 1)
_LINK_OFF = ((0, 0), (1, 0), (0, 1), (0, 0))
_PLAQUETTE = (1, 1, -1, -1)


class WormDraws:
    """Draw source of :func:`plain_worms` from a ``torch.Generator``.

    ``start()`` gives each chain's orientation (B,) and tail and head (B, 2);
    ``move()`` each chain's close uniform, move choice in 0..3 and Metropolis
    uniform (B,), one call per move."""

    def __init__(self, generator, *, B, N, fdt, device):
        self.generator, self.B, self.N, self.fdt, self.device = generator, B, N, fdt, device

    def start(self):
        g, B, dev = self.generator, self.B, self.device
        orientation = 2 * torch.randint(0, 2, (B,), generator=g, device=dev) - 1
        tail = torch.randint(0, self.N, (B, 2), generator=g, device=dev)
        head = torch.randint(0, self.N, (B, 2), generator=g, device=dev)
        return orientation, tail, head

    def move(self):
        g, B, dev = self.generator, self.B, self.device
        u = torch.rand((2, B), generator=g, dtype=self.fdt, device=dev)
        choice = torch.randint(0, 4, (B,), generator=g, device=dev)
        return u[0], choice, u[1]


class KernelWormDraws:
    """The draws of one CUDA worm-kernel call seeded with ``seed``, as a draw
    source of :func:`plain_worms`: Philox-4x32-10 keyed by the seed and
    countered by (chain, worm, 0 or 1, 0) for a worm's start and (chain, worm,
    move, odd) for each move, the chain word being ``chain0`` + the chain's
    index in the batch, with the kernel's conversions (``csrc/worm.cu``).
    Moves are drawn ``BLOCK`` at a time, one Philox evaluation per block."""

    BLOCK = 256

    def __init__(self, seed, *, B, N, device, chain0=0):
        self.key = philox.key_of(seed)
        self.N, self.device = N, device
        self.chain = chain0 + torch.arange(B, device=device)
        self.worm, self.moves = -1, 0

    def _site(self, word):
        return (word * self.N) >> 32

    def start(self):
        self.worm += 1
        self.moves = 0
        s0 = philox.philox4x32_10((self.chain, self.worm, 0, 0), self.key, self.device)
        s1 = philox.philox4x32_10((self.chain, self.worm, 1, 0), self.key, self.device)
        orientation = torch.where((s0[0] >> 31) == 1, 1, -1)
        tail = torch.stack([self._site(s0[1]), self._site(s0[2])], dim=-1)
        head = torch.stack([self._site(s1[0]), self._site(s1[1])], dim=-1)
        return orientation, tail, head

    def move(self):
        k = self.moves % self.BLOCK
        if k == 0:
            t = self.moves + torch.arange(self.BLOCK, device=self.device)
            m = philox.philox4x32_10((self.chain[:, None], self.worm, t & philox.MASK,
                                      2 * (t >> 32) + 1), self.key, self.device)
            self._buffer = (philox.u24(m[0]), m[1] & 3, philox.u24(m[2]))
        self.moves += 1
        return tuple(b[:, k] for b in self._buffer)


def plain_worms(phi, n, *, kappa, W, worms, max_worm_moves, draws):
    """``worms`` classic worms per chain in plain PyTorch, on any device.

    A worm still open after ``max_worm_moves`` moves is rolled back at W != 1
    (its open configuration violates dn ≡ 0 mod W); at W = 1 it is kept.
    Returns ``(n, hist, length, truncated)`` like :func:`classic_worms`."""
    B, _, N, _ = n.shape
    L = lattice(N)
    dev, fdt = n.device, phi.dtype
    n = n.clone()
    dphi = calc.d(L, 0, phi)
    moves = torch.tensor(_MOVES, device=dev)
    link_dir = torch.tensor(_LINK_DIR, device=dev)
    link_off = torch.tensor(_LINK_OFF, device=dev)
    plaquette = torch.tensor(_PLAQUETTE, dtype=n.dtype, device=dev)
    chains = torch.arange(B, device=dev)
    hist = torch.zeros((B, N, N), dtype=fdt, device=dev)
    truncated = torch.zeros(B, dtype=fdt, device=dev)
    rollback = max_worm_moves is not None and W != 1

    for _ in range(worms):
        orientation, tail, head = draws.start()
        if W != 1:
            head = tail
        change_n = orientation[:, None].to(n.dtype) * plaquette
        start = n.clone() if rollback else None
        open_ = torch.ones(B, dtype=torch.bool, device=dev)
        t = 0
        while (max_worm_moves is None or t < max_worm_moves) and bool(open_.any()):
            u_close, choice, u_accept = draws.move()
            closed = (head == tail).all(dim=-1) | (W == 1)
            close_now = closed & (u_close >= 0.8)

            next_head = torch.remainder(head + moves[choice], N)
            ld = link_dir[choice]
            lpos = torch.remainder(head + link_off[choice], N)
            at = (chains, ld, lpos[:, 0], lpos[:, 1])
            link_val = dphi[at] - TWO_PI * n[at].to(fdt)
            dn = change_n[chains, choice]
            dnf = dn.to(fdt)
            dS = (kappa / 2) * (-TWO_PI * dnf) * (2 * link_val - TWO_PI * dnf)
            accept = (u_accept < torch.clamp(torch.exp(-dS), max=1.0)) & ~close_now & open_

            n[at] = n[at] + torch.where(accept, dn, 0)
            head = torch.where(accept[:, None], next_head, head)
            disp = torch.remainder(head - tail, N)
            tally = (chains, disp[:, 0], disp[:, 1])
            hist[tally] = hist[tally] + (open_ & ~close_now).to(fdt)
            open_ = open_ & ~close_now
            t += 1
        if rollback:
            n = torch.where(open_[:, None, None, None], start, n)
            truncated = truncated + open_.to(fdt)
    return n, hist, hist.sum(dim=(1, 2)), truncated


def classic_worms(phi, n, *, kappa, W, worms=1, max_worm_moves=None, generator, chain0=None):
    """Run ``worms`` whole classic worms per chain.

    Parameters
    ----------
    phi: (B, 1, N, N) float — read only; n: (B, 2, N, N) int
    max_worm_moves: per-worm move cap (exact rollback at W != 1) or None
    generator: ``torch.Generator`` or a shard's :class:`.shard.ShardGenerator`
        — the kernel seed, on the CPU (:class:`KernelWormDraws`) as on a GPU
    chain0: the global index of the batch's first chain, which the kernel's
        stream counts from (default: the generator's, 0 for a ``torch.Generator``)

    Returns
    -------
    (n, hist, length, truncated): updated links, the summed inline
    ``Vortex_Vortex`` histogram (B, N, N), the total worm length (B,) and the
    number of truncated (rolled back) worms (B,).
    """
    chain0 = shard.resolve_chain0(generator, chain0, phi.device)
    if phi.device.type == 'cpu':
        draws = KernelWormDraws(kernels.seed_from(generator), B=n.shape[0], N=n.shape[-1],
                                device=phi.device, chain0=chain0)
        return plain_worms(phi, n, kappa=kappa, W=W, worms=worms,
                           max_worm_moves=max_worm_moves, draws=draws)
    if phi.device.type != 'cuda':
        raise ValueError(f'classic_worms runs on the CPU or a CUDA device, not {phi.device}')

    B, N = kernels.require_fields(phi, n)
    cap = -1 if max_worm_moves is None else int(max_worm_moves)
    rollback = cap >= 0 and W != 1
    lib = kernels.library()
    n_out = torch.empty_like(n)
    hist = torch.empty((B, N, N), dtype=torch.float32, device=phi.device)
    stat = torch.empty((B, 2), dtype=torch.float32, device=phi.device)
    log_words = (cap + 15) // 16 if rollback else 0
    log = torch.empty((B, log_words), dtype=torch.int32, device=phi.device) if rollback else None
    seed = kernels.seed_from(generator)
    with torch.cuda.device(phi.device):
        code = lib.sv_worms(
            phi.data_ptr(), n.data_ptr(), n_out.data_ptr(), hist.data_ptr(), stat.data_ptr(),
            None if log is None else log.data_ptr(), log_words, B, N, float(kappa),
            int(W == 1), int(worms), cap, int(rollback), seed, kernels.chain_word(chain0, B),
            kernels.stream_handle(phi.device))
    kernels.check(code, 'classic_worms')
    classic_worms.launches += 1
    return n_out, hist, stat[:, 0], stat[:, 1]


#: Calls that launched the CUDA kernel (the CPU path never counts).
classic_worms.launches = 0


class KernelChunkedWormDraws:
    """The draws of one ChunkedWorm-kernel call (K1) seeded with ``seed``, as a
    draw source of :func:`plain_chunked_worms`: Philox-4x32-10 keyed by the
    seed's ChunkedWorm key and countered by (chain, move, 0, 0) for the close
    uniform, the choice (word & 3), the Metropolis uniform and the restart's
    orientation (the fourth word's top bit), and (chain, move, 1, 0) for the
    restart's tail and head, the chain word being ``chain0`` + the chain's
    index in the batch, with the kernel's conversions (``csrc/worm.cu``)."""

    def __init__(self, seed, *, B, N, device, chain0=0):
        self.key = philox.chunked_key(seed)
        self.N, self.device = N, device
        self.chain = chain0 + torch.arange(B, device=device)

    def chunk(self, T):
        t = torch.arange(T, device=self.device)[:, None]
        m = philox.philox4x32_10((self.chain, t, 0, 0), self.key, self.device)
        r = philox.philox4x32_10((self.chain, t, 1, 0), self.key, self.device)
        restart = torch.stack([(w * self.N) >> 32 for w in r], dim=-1)
        orientation = torch.where((m[3] >> 31) == 1, 1, -1)
        return philox.u24(m[0]), m[1] & 3, philox.u24(m[2]), restart, orientation


def plain_chunked_worms(phi, n, worm, *, kappa, moves, draws):
    """``moves`` ChunkedWorm micro-moves per chain in plain PyTorch, on any
    device, from each chain's carried worm (B, 5): head (t, x), tail (t, x),
    orientation.  The move rule of the JAX ``ChunkedWorm.step`` (W=1, so
    every move finds the worm closed): a close (probability 0.2) restarts a
    fresh worm at once; any other move is the classic worm's Metropolis move
    and tallies head − tail.  Returns ``(n, worm, hist, length, closes)`` like
    :func:`chunked_worms`."""
    B, _, N, _ = n.shape
    L = lattice(N)
    dev, fdt = n.device, phi.dtype
    dphi = calc.d(L, 0, phi).reshape(-1)
    flat = n.reshape(-1).clone()
    worm = worm.long()
    head, tail, orientation = worm[:, :2], worm[:, 2:4], worm[:, 4].to(n.dtype)
    u_close, choices, u_accept, restarts, orients = draws.chunk(moves)
    step = torch.tensor(_MOVES, device=dev)
    link_dir = torch.tensor(_LINK_DIR, device=dev)
    link_off = torch.tensor(_LINK_OFF, device=dev)
    plaquette = torch.tensor(_PLAQUETTE, dtype=n.dtype, device=dev)
    base = torch.arange(B, device=dev) * (2 * N * N)
    hist = torch.zeros(B * N * N, dtype=fdt, device=dev)
    closes = torch.zeros(B, dtype=fdt, device=dev)

    for i in range(moves):
        close_now = u_close[i] >= 0.8                    # W=1: always closed
        choice = choices[i]
        next_head = torch.remainder(head + step[choice], N)
        lpos = torch.remainder(head + link_off[choice], N)
        at = base + link_dir[choice] * (N * N) + lpos[:, 0] * N + lpos[:, 1]
        dn = orientation * plaquette[choice]
        dnf = dn.to(fdt)
        link = dphi[at] - TWO_PI * flat[at].to(fdt)
        dS = (kappa / 2) * (-TWO_PI * dnf) * (2 * link - TWO_PI * dnf)
        accept = (u_accept[i] < torch.clamp(torch.exp(-dS), max=1.0)) & ~close_now
        flat.index_add_(0, at, torch.where(accept, dn, 0))
        head = torch.where(accept[:, None], next_head, head)
        disp = torch.remainder(head - tail, N)
        hist.index_add_(0, base // 2 + disp[:, 0] * N + disp[:, 1], (~close_now).to(fdt))
        # Close and restart: a fresh worm within the same chunk.
        restart = restarts[i].to(head.dtype)
        tail = torch.where(close_now[:, None], restart[:, :2], tail)
        head = torch.where(close_now[:, None], restart[:, 2:], head)
        orientation = torch.where(close_now, orients[i].to(n.dtype), orientation)
        closes = closes + close_now.to(fdt)

    hist = hist.reshape(B, N, N)
    worm = torch.cat([head, tail, orientation[:, None].long()], dim=1).to(torch.int32)
    return flat.reshape(n.shape), worm, hist, hist.sum(dim=(1, 2)), closes


def chunked_worms(phi, n, worm, *, kappa, moves, generator, chain0=None):
    """Run ``moves`` ChunkedWorm micro-moves per chain (Villain, D=2, W=1).

    Parameters
    ----------
    phi: (B, 1, N, N) float — read only; n: (B, 2, N, N) int
    worm: (B, 5) int32 — each chain's carried worm (head t, x, tail t, x,
        orientation), as ``ChunkedWorm.prepare`` lays it out
    generator: ``torch.Generator`` or a shard's :class:`.shard.ShardGenerator`
        — the kernel seed, on the CPU (:class:`KernelChunkedWormDraws`) as on a GPU
    chain0: the global index of the batch's first chain, which the kernel's
        stream counts from (default: the generator's, 0 for a ``torch.Generator``)

    Returns
    -------
    (n, worm, hist, length, closes): updated links, the worm state after the
    last move, the ``Vortex_Vortex`` histogram (B, N, N), the moves tallied
    (B,) and the worms closed (B,).
    """
    moves = int(moves)
    if not 0 <= moves < 2 ** 31:
        raise ValueError(f'moves must lie in [0, 2**31), got {moves}')
    chain0 = shard.resolve_chain0(generator, chain0, phi.device)
    if phi.device.type == 'cpu':
        draws = KernelChunkedWormDraws(kernels.seed_from(generator), B=n.shape[0],
                                       N=n.shape[-1], device=phi.device, chain0=chain0)
        return plain_chunked_worms(phi, n, worm, kappa=kappa, moves=moves, draws=draws)
    if phi.device.type != 'cuda':
        raise ValueError(f'chunked_worms runs on the CPU or a CUDA device, not {phi.device}')

    B, N = kernels.require_fields(phi, n)
    if worm.device != phi.device or worm.dtype != torch.int32 or tuple(worm.shape) != (B, 5):
        raise ValueError(f'the worm state must be ({B}, 5) int32 on {phi.device}, got '
                         f'{tuple(worm.shape)} {worm.dtype} on {worm.device}')
    worm = worm.contiguous()
    lib = kernels.library()
    n_out = torch.empty_like(n)
    worm_out = torch.empty_like(worm)
    hist = torch.empty((B, N, N), dtype=torch.float32, device=phi.device)
    stat = torch.empty((B, 2), dtype=torch.float32, device=phi.device)
    seed = kernels.seed_from(generator)
    with torch.cuda.device(phi.device):
        code = lib.sv_chunked_worms(
            phi.data_ptr(), n.data_ptr(), n_out.data_ptr(), worm.data_ptr(), worm_out.data_ptr(),
            hist.data_ptr(), stat.data_ptr(), B, N, float(kappa / 2), moves, seed,
            kernels.chain_word(chain0, B), kernels.stream_handle(phi.device))
    kernels.check(code, 'chunked_worms')
    chunked_worms.launches += 1
    return n_out, worm_out, hist, stat[:, 0], stat[:, 1]


#: Calls that launched the CUDA kernel (the CPU path never counts).
chunked_worms.launches = 0
