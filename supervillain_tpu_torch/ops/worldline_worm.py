"""Worldline classic (site) worms: the CUDA kernel and its plain PyTorch twin.

Counterpart of :func:`supervillain_tpu.ops.pallas_worldline_hammer.worldline_worms`.
:func:`worldline_worms` dispatches by device: a CPU batch runs
:func:`plain_worldline_worms` with draws from a ``torch.Generator``, a CUDA
batch runs the kernel of ``csrc/worldline_worm.cu``, and any other device raises.

The plain version is the move rule of
:class:`supervillain_tpu.generators.worldline.ClassicWorm`, advancing all
chains one move per iteration (a chain whose worm has closed stops drawing),
with the draws coming from a draw source: a ``torch.Generator``
(:class:`WorldlineWormDraws`), the JAX package's own (tests), or the kernel's
Philox stream (:class:`KernelWorldlineWormDraws`).  The worm changes only m; the
crossed link's residual is m − δv/_W with δv/_W fixed for the call.
"""

from __future__ import annotations

import torch

from . import calculus as calc
from . import kernels, philox
from .sweep import lattice
from .worldline import inverse_w
from ..device import float_dtype_of

# Head moves +e0, +e1, −e0, −e1 in (t, x); the crossed link's direction; Δm's sign.
_MOVES = ((1, 0), (0, 1), (-1, 0), (0, -1))
_AXIS = (0, 1, 0, 1)
_SIGN = (1, 1, -1, -1)
#: Probability of the close move when head == tail: 1/(2D+1) in D=2.
CLOSE = 0.2


class WorldlineWormDraws:
    """Draw source of :func:`plain_worldline_worms` from a ``torch.Generator``.

    ``start()`` gives each chain's orientation (B,) and tail (B, 2); ``move()``
    each chain's close uniform, move choice in 0..3 and Metropolis uniform (B,),
    one call per move."""

    def __init__(self, generator, *, B, N, fdt, device):
        self.generator, self.B, self.N, self.fdt, self.device = generator, B, N, fdt, device

    def start(self):
        g, B, dev = self.generator, self.B, self.device
        orientation = 2 * torch.randint(0, 2, (B,), generator=g, device=dev) - 1
        return orientation, torch.randint(0, self.N, (B, 2), generator=g, device=dev)

    def move(self):
        g, B, dev = self.generator, self.B, self.device
        u = torch.rand((2, B), generator=g, dtype=self.fdt, device=dev)
        return u[0], torch.randint(0, 4, (B,), generator=g, device=dev), u[1]


class KernelWorldlineWormDraws:
    """The draws of one CUDA worldline-worm call seeded with ``seed``, as a draw
    source of :func:`plain_worldline_worms`: Philox-4x32-10 keyed by the seed's
    Worldline key and countered by (chain, worm, 0, 2) for a worm's start and
    (chain, worm, move, odd) for each move, with the kernel's conversions
    (``csrc/worldline_worm.cu``).  Moves are drawn ``BLOCK`` at a time: one
    Philox evaluation per block instead of per move keeps a replay of long worms
    affordable."""

    BLOCK = 256

    def __init__(self, seed, *, B, N, device):
        self.key = philox.worldline_key(seed)
        self.N, self.device = N, device
        self.chain = torch.arange(B, device=device)
        self.worm, self.moves = -1, 0

    def _site(self, word):
        return (word * self.N) >> 32

    def start(self):
        self.worm += 1
        self.moves = 0
        s = philox.philox4x32_10((self.chain, self.worm, 0, 2), self.key, self.device)
        orientation = torch.where((s[0] >> 31) == 1, 1, -1)
        return orientation, torch.stack([self._site(s[1]), self._site(s[2])], dim=-1)

    def move(self):
        k = self.moves % self.BLOCK
        if k == 0:
            t = self.moves + torch.arange(self.BLOCK, device=self.device)
            w = philox.philox4x32_10((self.chain[:, None], self.worm, t & philox.MASK,
                                      2 * (t >> 32) + 1), self.key, self.device)
            self._buffer = (philox.u24(w[0]), w[1] & 3, philox.u24(w[2]))
        self.moves += 1
        return tuple(b[:, k] for b in self._buffer)


def plain_worldline_worms(m, v, *, kappa, W, worms, max_worm_moves, draws):
    """``worms`` worldline worms per chain in plain PyTorch, on any device.

    A worm still open after ``max_worm_moves`` moves is rolled back (an open
    worm breaks δm = 0 at every W).  Returns ``(m, hist, length, truncated)``
    like :func:`worldline_worms`."""
    B, _, N, _ = m.shape
    L = lattice(N)
    dev, fdt = m.device, float_dtype_of(v)
    m = m.clone()
    dvw = calc.delta(L, 2, v).to(fdt) * inverse_w(W)
    moves = torch.tensor(_MOVES, device=dev)
    axis = torch.tensor(_AXIS, device=dev)
    sign = torch.tensor(_SIGN, dtype=m.dtype, device=dev)
    chains = torch.arange(B, device=dev)
    hist = torch.zeros((B, N, N), dtype=fdt, device=dev)
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
            close_now = (head == tail).all(dim=-1) & (u_close < CLOSE)
            next_head = torch.remainder(head + moves[choice], N)
            lpos = torch.where((choice < 2)[:, None], head, next_head)
            at = (chains, axis[choice], lpos[:, 0], lpos[:, 1])
            link = m[at].to(fdt) - dvw[at]
            dm = change_m[chains, choice]
            dmf = dm.to(fdt)
            dS = (0.5 / kappa) * dmf * (2 * link + dmf)
            accept = (u_accept < torch.clamp(torch.exp(-dS), max=1.0)) & ~close_now & open_

            m[at] = m[at] + torch.where(accept, dm, 0)
            head = torch.where(accept[:, None], next_head, head)
            disp = torch.remainder(head - tail, N)
            tally = (chains, disp[:, 0], disp[:, 1])
            hist[tally] = hist[tally] + (open_ & ~close_now).to(fdt)
            open_ = open_ & ~close_now
            t += 1
        if rollback:
            m = torch.where(open_[:, None, None, None], start, m)
            truncated = truncated + open_.to(fdt)
    return m, hist, hist.sum(dim=(1, 2)), truncated


def worldline_worms(m, v, *, kappa, W, worms=1, max_worm_moves=None, generator):
    """Run ``worms`` whole worldline worms per chain.

    Parameters
    ----------
    m: (B, 2, N, N) int; v: (B, 1, N, N) int or float (W = inf) — read only
    max_worm_moves: per-worm move cap (exact rollback of an unclosed worm) or None
    generator: ``torch.Generator`` — the draws on the CPU, the kernel seed on a GPU

    Returns
    -------
    (m, hist, length, truncated): updated links with δm = 0, the summed inline
    ``Spin_Spin`` histogram (B, N, N), the total worm length (B,) and the
    number of truncated (rolled back) worms (B,).
    """
    if m.device.type == 'cpu':
        draws = WorldlineWormDraws(generator, B=m.shape[0], N=m.shape[-1], fdt=float_dtype_of(v),
                                   device=m.device)
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
    code = entry(m.data_ptr(), v.data_ptr(), m_out.data_ptr(), packed.data_ptr(), hist.data_ptr(),
                 stat.data_ptr(), None if log is None else log.data_ptr(), log_words, B, N,
                 float(0.5 / kappa),
                 float(inverse_w(W)), int(worms), cap, kernels.seed_from(generator),
                 kernels.stream_handle(m.device))
    kernels.check(code, 'worldline_worms')
    worldline_worms.launches += 1
    return m_out, hist, stat[:, 0], stat[:, 1]


#: Calls that launched the CUDA kernel (the CPU path never counts).
worldline_worms.launches = 0
