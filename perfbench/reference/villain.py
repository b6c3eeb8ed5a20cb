"""The plain reference of the Villain fleet: neighborhood sweeps and classic worms.

A straightforward PyTorch implementation of one Villain record of the fused
fleet, D = 2 and even N, for any set of chains of the fleet: each color pass
proposes Δφ ∈ ±interval_phi on the sites of one checkerboard color together
with Δn ∈ W·{−interval_n..interval_n} on their four links, and accepts by
Metropolis on ΔS of S = (κ/2) Σ (dφ − 2πn)²; after the sweeps each chain runs
its worms, a walk of the plaquette defect that tallies the ``Vortex_Vortex``
histogram.  The random numbers are the program's kernels' own Philox stream
(:mod:`.philox`), counted by each chain's global index, so that the reference
replays the chains it is given draw for draw.  ``dtype`` is the float type of
φ, of the residual and of every float operation: float32 as the configuration
states, bfloat16 for the control.
"""

from __future__ import annotations

import math

import torch

from . import philox

TWO_PI = 2 * math.pi
# The worm's plaquette moves (east, north, west, south) in (t, x), the link
# each crosses, its offset from the head, and the Δn of the move.
_MOVES = ((0, -1), (1, 0), (0, 1), (-1, 0))
_LINK_DIR = (0, 1, 0, 1)
_LINK_OFF = ((0, 0), (1, 0), (0, 1), (0, 0))
_PLAQUETTE = (1, 1, -1, -1)
#: Color passes whose draws are made in one Philox evaluation, at most, and
#: the draws' elements it may hold (each int64 word 8 bytes).
PASS_CHUNK = 50
DRAW_ELEMENTS = 2 ** 25


def mask(N, color, device):
    """Sites (t, x) of checkerboard color ``color``: (t + x) % 2 == color."""
    i = torch.arange(N, device=device)
    return ((i[:, None] + i[None, :]) % 2) == color


def d0(phi):
    """The links' dφ: (B, 2, N, N) from φ (B, 1, N, N), forward differences in t and x."""
    p = phi[:, 0]
    return torch.stack([torch.roll(p, -1, dims=-2) - p, torch.roll(p, -1, dims=-1) - p], dim=1)


def d1(n):
    """The plaquettes' dn: (B, 1, N, N), Δ_t n_x − Δ_x n_t."""
    return ((torch.roll(n[:, 1], -1, dims=-2) - n[:, 1])
            + (-(torch.roll(n[:, 0], -1, dims=-1) - n[:, 0])))[:, None]


def face_sum(f):
    """Per-link values (B, 2, N, N) summed onto each link's two end sites."""
    return ((f[:, 0] + torch.roll(f[:, 0], 1, dims=-2))
            + (f[:, 1] + torch.roll(f[:, 1], 1, dims=-1)))[:, None]


def _int(a, b, interval_n, p_n, idt):
    """The kernels' integer draw: uniform in {−i..i}, or zero-inflated with ``p_n``."""
    if p_n is None:
        return torch.floor(philox.u24(a) * float(2 * interval_n + 1)).to(idt) - interval_n
    u = philox.u24(a)
    mag = 1 if interval_n == 1 else torch.floor(philox.u24(b) * float(interval_n)).to(idt) + 1
    sign = (u < 0.5 * p_n).to(idt) - ((u >= 0.5 * p_n) & (u < p_n)).to(idt)
    return sign * mag


def pass_draws(seed, chains, N, first, count, *, interval_phi, interval_n, p_n, dtype, idt):
    """The draws of color passes ``first`` .. ``first + count − 1`` of one sweep
    call keyed by ``seed``, for the global chain indices ``chains``: a list of
    dicts {'phi', 'u', 'fwd', 'bwd'}, each over every site (B, ...)."""
    dev = chains.device
    key = philox.key_of(seed)
    site = torch.arange(N * N, device=dev).reshape(1, 1, N, N)
    chain = chains.reshape(-1, 1, 1, 1)
    passes = (first + torch.arange(count, device=dev)).reshape(1, count, 1, 1)

    def words(k):
        return philox.philox((site, chain, passes, k), key, dev)

    w0, w1 = words(0), words(1)
    w2 = words(2) if p_n is not None and interval_n > 1 else (0,) * 4

    def draw(a, b):
        return _int(a, b, interval_n, p_n, idt)

    phi = ((2 * philox.u24(w0[0]) - 1) * interval_phi).to(dtype)
    u = philox.u24(w0[1]).to(dtype)
    fwd = torch.stack([draw(w0[2], w1[2]), draw(w0[3], w1[3])], dim=2)
    # The kernel draws a backward link's Δn at the site it ends on; the passes
    # index it by the link's own position x − e_μ.
    back = [draw(w1[0], w2[0]), draw(w1[1], w2[1])]
    bwd = torch.stack([torch.roll(back[mu], -1, dims=mu - 2) for mu in range(2)], dim=2)
    return [{'phi': phi[:, p], 'u': u[:, p], 'fwd': fwd[:, p], 'bwd': bwd[:, p]}
            for p in range(count)]


def color_pass(phi, n, r, color, draws, *, kappa, W):
    """One checkerboard color pass: returns (φ, n, r, accepted per chain)."""
    N = phi.shape[-1]
    m = mask(N, color, phi.device)
    change_phi = torch.where(m, draws['phi'], 0)[:, None]
    fwd, bwd = W * draws['fwd'], W * draws['bwd']
    change_fwd = torch.stack([torch.where(m, fwd[:, mu], 0) for mu in range(2)], dim=1)
    change_bwd = torch.stack([torch.where(torch.roll(m, -1, dims=mu - 2), bwd[:, mu], 0)
                              for mu in range(2)], dim=1)
    change_n = change_fwd + change_bwd
    change_r = d0(change_phi) - TWO_PI * change_n.to(phi.dtype)
    dS_link = (kappa / 2) * change_r * (2 * r + change_r)
    dS = face_sum(dS_link)[:, 0]
    accept = (draws['u'] < torch.clamp(torch.exp(-dS), max=1.0)) & m
    applied_phi = torch.where(accept, change_phi[:, 0], 0)[:, None]
    applied_n = torch.stack(
        [torch.where(accept, change_fwd[:, mu], 0)
         + torch.where(torch.roll(accept, -1, dims=mu - 2), change_bwd[:, mu], 0)
         for mu in range(2)], dim=1)
    phi = phi + applied_phi
    n = n + applied_n
    r = r + d0(applied_phi) - TWO_PI * applied_n.to(phi.dtype)
    return phi, n, r, accept.sum(dim=(-2, -1)).to(phi.dtype)


def sweeps(phi, n, seed, chains, *, kappa, W, interval_phi, interval_n, p_n, sweeps):
    """``sweeps`` neighborhood sweeps of one kernel call keyed by ``seed``.
    Returns (φ, n, accepted, {'ActionDensity', 'WindingSquared'})."""
    if W == float('inf'):
        raise ValueError('the reference sweeps finite W only')
    N, dtype = phi.shape[-1], phi.dtype
    r = d0(phi) - TWO_PI * n.to(dtype)
    B = phi.shape[0]
    accepted = torch.zeros(B, dtype=dtype, device=phi.device)
    sS, sw2 = torch.zeros_like(accepted), torch.zeros_like(accepted)
    draws = []
    for p in range(2 * sweeps):
        if not draws:
            count = max(1, min(PASS_CHUNK, 2 * sweeps - p, DRAW_ELEMENTS // (B * N * N)))
            draws = pass_draws(seed, chains, N, p, count, interval_phi=interval_phi,
                               interval_n=interval_n, p_n=p_n, dtype=dtype, idt=n.dtype)
        phi, n, r, acc = color_pass(phi, n, r, p % 2, draws.pop(0), kappa=kappa, W=W)
        accepted = accepted + acc
        if p % 2:
            sS = sS + (kappa / 2) * torch.sum(r * r, dim=(1, 2, 3)) / (N * N)
            dn = d1(n).to(dtype)
            sw2 = sw2 + torch.sum(dn * dn, dim=(1, 2, 3)) / (N * N)
    return phi, n, accepted, {'ActionDensity': sS / sweeps, 'WindingSquared': sw2 / sweeps}


class WormDraws:
    """The worm kernel's draws keyed by ``seed``: Philox countered by (chain,
    worm, 0 or 1, 0) for a worm's start and (chain, worm, move, odd) for its
    moves, ``BLOCK`` moves at a time."""

    BLOCK = 256

    def __init__(self, seed, chains, N, dtype):
        self.key, self.chain, self.N, self.dtype = philox.key_of(seed), chains, N, dtype
        self.worm, self.moves = -1, 0

    def start(self):
        self.worm += 1
        self.moves = 0
        dev = self.chain.device
        s0 = philox.philox((self.chain, self.worm, 0, 0), self.key, dev)
        s1 = philox.philox((self.chain, self.worm, 1, 0), self.key, dev)
        orientation = torch.where((s0[0] >> 31) == 1, 1, -1)
        site = lambda w: (w * self.N) >> 32  # noqa: E731
        return (orientation, torch.stack([site(s0[1]), site(s0[2])], dim=-1),
                torch.stack([site(s1[0]), site(s1[1])], dim=-1))

    def move(self):
        k = self.moves % self.BLOCK
        if k == 0:
            t = self.moves + torch.arange(self.BLOCK, device=self.chain.device)
            w = philox.philox((self.chain[:, None], self.worm, t & philox.MASK,
                               2 * (t >> 32) + 1), self.key, self.chain.device)
            self._buffer = (philox.u24(w[0]).to(self.dtype), w[1] & 3,
                            philox.u24(w[2]).to(self.dtype))
        self.moves += 1
        return tuple(b[:, k] for b in self._buffer)


def worms(phi, n, seed, chains, *, kappa, W, worms, max_worm_moves):
    """``worms`` classic worms a chain of one worm-kernel call keyed by
    ``seed``, all chains a move at a time.  A worm still open at the cap is
    rolled back at W != 1.  Returns (n, Vortex_Vortex, Worm_Length, Worm_Truncated)."""
    B, _, N, _ = n.shape
    dev, fdt = n.device, phi.dtype
    draws = WormDraws(seed, chains, N, fdt)
    n = n.clone()
    dphi = d0(phi)
    moves = torch.tensor(_MOVES, device=dev)
    link_dir = torch.tensor(_LINK_DIR, device=dev)
    link_off = torch.tensor(_LINK_OFF, device=dev)
    plaquette = torch.tensor(_PLAQUETTE, dtype=n.dtype, device=dev)
    rows = torch.arange(B, device=dev)
    hist = torch.zeros((B, N, N), dtype=torch.float32, device=dev)
    truncated = torch.zeros(B, dtype=torch.float32, device=dev)
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
            lpos = torch.remainder(head + link_off[choice], N)
            at = (rows, link_dir[choice], lpos[:, 0], lpos[:, 1])
            link = dphi[at] - TWO_PI * n[at].to(fdt)
            dn = change_n[rows, choice]
            dnf = dn.to(fdt)
            dS = (kappa / 2) * (-TWO_PI * dnf) * (2 * link - TWO_PI * dnf)
            accept = (u_accept < torch.clamp(torch.exp(-dS), max=1.0)) & ~close_now & open_
            n[at] = n[at] + torch.where(accept, dn, 0)
            head = torch.where(accept[:, None], next_head, head)
            disp = torch.remainder(head - tail, N)
            tally = (rows, disp[:, 0], disp[:, 1])
            hist[tally] = hist[tally] + (open_ & ~close_now).float()
            open_ = open_ & ~close_now
            t += 1
        if rollback:
            n = torch.where(open_[:, None, None, None], start, n)
            truncated = truncated + open_.float()
    return n, hist, hist.sum(dim=(1, 2)), truncated


def cold(B, N, device, dtype):
    """The fleet's cold start: φ = 0 and n = 0."""
    return (torch.zeros((B, 1, N, N), dtype=dtype, device=device),
            torch.zeros((B, 2, N, N), dtype=torch.int32, device=device))


def record(state, seeds, chains, traffic, dtype=None):
    """One record of the fused fleet from ``state`` (φ, n): the sweep call and,
    with worms, the worm call, keyed by the next of ``seeds`` each.  The float
    type is the state's.  Returns the new state and the record's inline columns."""
    phi, n = state
    t = traffic
    phi, n, _, inline = sweeps(phi, n, next(seeds), chains, kappa=t['kappa'], W=t['W'],
                               interval_phi=t['interval_phi'], interval_n=t['interval_n'],
                               p_n=t['p_n'], sweeps=t['thin'])
    if t['worms'] > 0:
        n, hist, length, truncated = worms(phi, n, next(seeds), chains, kappa=t['kappa'],
                                           W=t['W'], worms=t['worms'],
                                           max_worm_moves=t['max_worm_moves'])
        inline = inline | {'Vortex_Vortex': hist, 'Worm_Length': length,
                           'Worm_Truncated': truncated}
    return (phi, n), inline


FIELDS = ('phi', 'n')
