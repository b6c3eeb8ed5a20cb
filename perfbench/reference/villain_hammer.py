"""The plain reference of the general Villain fleet: ``Hammer(S, fleet=True)`` at W=1.

A straightforward PyTorch replay of one call of ``sample_fleet`` with the
Villain Hammer for a fleet (D = 2, even N, W = 1, upstream's default
proposal widths), for any sample of the fleet's chains, from the cold start
(φ = 0, n = 0, the open worm at the origin, head = tail, orientation +1).
S = (κ/2) Σ_links (dφ − 2πn)², and each Hammer step runs, in this order:

1. the site update: for each checkerboard color, Δφ ~ U(−π, π) on its sites,
   accepted by Metropolis on ΔS = Σ_links at the site (κ/2)·dΔφ·(2r + dΔφ)
   from the residual r = dφ − 2πn, kept up to date through the passes;
2. the link update: Δn = ±W on every link at once, φ fixed, ΔS =
   −2πκΔn·(dφ − 2πn − πΔn);
3. the exact update: for each color, Δz = ±1 on its sites and Δn = dΔz on
   their links, ΔS the link formula summed onto the site;
4. the cohomology update: for each direction μ, h = ±1 added to n_μ on the
   slice x_μ = 0, accepted on ΔS summed over the slice;
5. the chunked worm: 64 micro-moves of the plaquette worm, each a close with
   probability 0.2 (a fresh worm restarts at once) or a Metropolis move of the
   head across a link, which tallies head − tail into ``Vortex_Vortex``.

A record is ``thin`` steps; its inline ``Vortex_Vortex`` and ``Worm_Length``
(the moves tallied) are their sums over the record's steps over ``thin``.

Random numbers, as the program draws them: one ``torch.Generator`` on the
device, seeded with the call's fleet seed, draws every proposal and uniform
over the whole fleet (the chains its leading axis), in the order above, and
the replay keeps the rows of its sampled chains; each worm call takes a 63-bit
kernel seed drawn from it, and its moves come from Philox-4x32-10
(:mod:`.philox`) keyed by that seed ⊕ ``CHUNKED_SALT`` and countered by (the
chain's index in the fleet, move, 0 or 1, 0).  ``dtype`` is the float type of
φ and of every float operation: float32 as the configuration states, bfloat16
for the control; the uniforms are drawn in float32 either way, so that the
control draws what the program draws.

Departures from upstream (``supervillain/generator/villain/`` of
evanberkowitz/supervillain v1.0.0):

- upstream draws from a NumPy ``default_rng`` a generator, in float64; here
  the fleet's one generator draws in the program's order, in float32;
- upstream runs one configuration; here each chain of the fleet proposes and
  accepts on its own, the cohomology update's h_μ too;
- upstream's Hammer ends with whole classic worms; the fleet's ends with the
  chunked worm (64 micro-moves a step, the open worm carried between steps),
  which is only unbiased at W = 1, where every configuration is valid.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import philox

TWO_PI = 2 * math.pi
#: Upstream's default proposal widths, and the fleet's worm chunk.
INTERVAL_PHI = math.pi
INTERVAL = 1            # Δn/W, Δz and h are ±1
WORM_MOVES = 64
# The worm's plaquette moves (east, north, west, south) in (t, x), the link
# each crosses, its offset from the head, and the Δn of the move.
_MOVES = ((0, -1), (1, 0), (0, 1), (-1, 0))
_LINK_DIR = (0, 1, 0, 1)
_LINK_OFF = ((0, 0), (1, 0), (0, 1), (0, 0))
_PLAQUETTE = (1, 1, -1, -1)
FIELDS = ('phi', 'n', 'worm')


def d0(f):
    """The links' df: (B, 2, N, N) from a 0-form (B, 1, N, N), forward
    differences in t and x."""
    p = f[:, 0]
    return torch.stack([torch.roll(p, -1, dims=-2) - p, torch.roll(p, -1, dims=-1) - p], dim=1)


def face_sum(f):
    """Per-link values (B, 2, N, N) summed onto each link's two end sites."""
    return ((f[:, 0] + torch.roll(f[:, 0], 1, dims=-2))
            + (f[:, 1] + torch.roll(f[:, 1], 1, dims=-1)))[:, None]


def metropolis(u, dS):
    return u < torch.clamp(torch.exp(-dS), max=1.0)


class FleetDraws:
    """The draws of a fleet of ``chains`` chains on one generator seeded with
    ``seed`` on ``device``, each made over the whole fleet; ``rows`` are the
    sampled chains whose draws are kept."""

    def __init__(self, seed, chains, rows, device):
        self.generator = torch.Generator(device=device).manual_seed(int(seed))
        self.chains, self.rows, self.device = chains, rows, device

    def uniform(self, shape, dtype):
        u = torch.rand((self.chains,) + shape, generator=self.generator, dtype=torch.float32,
                       device=self.device)
        return u[self.rows].to(dtype)

    def nonzero(self, shape):
        """Uniform over ±{1..INTERVAL}, int32."""
        r = torch.randint(0, 2 * INTERVAL, (self.chains,) + shape, generator=self.generator,
                          dtype=torch.int32, device=self.device)[self.rows]
        return torch.where(r < INTERVAL, r - INTERVAL, r - INTERVAL + 1)

    def kernel_seed(self):
        return int(torch.randint(0, 2 ** 63 - 1, (), generator=self.generator,
                                 device=self.device))


def colors(N, device):
    i = torch.arange(N, device=device)
    parity = (i[:, None] + i[None, :]) % 2
    return [parity == c for c in (0, 1)]


def link_delta_s(kappa, dphi, n, change_n):
    change = change_n.to(dphi.dtype)
    return (-TWO_PI * kappa * change) * (dphi - TWO_PI * n.to(dphi.dtype) - math.pi * change)


def site_update(phi, n, draws, masks, kappa):
    r = d0(phi) - TWO_PI * n.to(phi.dtype)
    shape = tuple(phi.shape[2:])
    for mask in masks:
        prop = (2 * draws.uniform(shape, phi.dtype) - 1) * INTERVAL_PHI
        change_phi = torch.where(mask, prop, 0)[:, None]
        cd = d0(change_phi)
        dS = face_sum((kappa / 2) * cd * (2 * r + cd))[:, 0]
        accept = metropolis(draws.uniform(shape, phi.dtype), dS) & mask
        applied = torch.where(accept, change_phi[:, 0], 0)[:, None]
        phi = phi + applied
        r = r + d0(applied)
    return phi


def link_update(phi, n, draws, kappa, W):
    change_n = W * draws.nonzero(tuple(n.shape[1:]))
    dS = link_delta_s(kappa, d0(phi), n, change_n)
    accept = metropolis(draws.uniform(tuple(n.shape[1:]), phi.dtype), dS)
    return n + torch.where(accept, change_n, 0)


def exact_update(phi, n, draws, masks, kappa):
    dphi = d0(phi)
    shape = tuple(phi.shape[2:])
    for mask in masks:
        change_z = torch.where(mask, draws.nonzero(shape), 0)[:, None]
        dS = face_sum(link_delta_s(kappa, dphi, n, d0(change_z)))[:, 0]
        accept = metropolis(draws.uniform(shape, phi.dtype), dS) & mask
        n = n + d0(torch.where(accept, change_z[:, 0], 0)[:, None])
    return n


def cohomology_update(phi, n, draws, kappa):
    r = d0(phi) - TWO_PI * n.to(phi.dtype)
    slices = [r[:, 0, 0, :].contiguous(), r[:, 1, :, 0].contiguous()]   # t = 0; x = 0
    decisions = []
    for r_slice in slices:
        h = draws.nonzero(())
        change_r = (-TWO_PI * h.to(r_slice.dtype))[:, None]
        dS = torch.sum((kappa / 2) * change_r * (2 * r_slice + change_r), dim=1)
        decisions.append(torch.where(metropolis(draws.uniform((), phi.dtype), dS), h, 0))
    n = n.clone()
    n[:, 0, 0, :] += decisions[0][:, None]
    n[:, 1, :, 0] += decisions[1][:, None]
    return n


def chunked_worm(phi, n, worm, seed, chains, kappa):
    """``WORM_MOVES`` micro-moves of each chain's carried worm (B, 5): head
    (t, x), tail (t, x), orientation.  Returns (n, worm, histogram, moves tallied)."""
    B, _, N, _ = n.shape
    dev, fdt = n.device, phi.dtype
    key = philox.key_of(seed ^ philox.CHUNKED_SALT)
    t = torch.arange(WORM_MOVES, device=dev)[:, None]
    m = philox.philox((chains, t, 0, 0), key, dev)
    restart = torch.stack([(w * N) >> 32 for w in philox.philox((chains, t, 1, 0), key, dev)],
                          dim=-1)
    close = philox.u24(m[0]) >= 0.8
    choices, u_accept = m[1] & 3, philox.u24(m[2]).to(fdt)
    orients = torch.where((m[3] >> 31) == 1, 1, -1)
    moves = torch.tensor(_MOVES, device=dev)
    link_dir = torch.tensor(_LINK_DIR, device=dev)
    link_off = torch.tensor(_LINK_OFF, device=dev)
    plaquette = torch.tensor(_PLAQUETTE, dtype=n.dtype, device=dev)
    rows = torch.arange(B, device=dev)
    dphi = d0(phi)
    n = n.clone()
    worm = worm.long()
    head, tail, orientation = worm[:, :2], worm[:, 2:4], worm[:, 4].to(n.dtype)
    hist = torch.zeros((B, N, N), dtype=torch.float32, device=dev)
    for i in range(WORM_MOVES):
        choice = choices[i]
        at = (rows, link_dir[choice], *torch.remainder(head + link_off[choice], N).unbind(-1))
        dn = orientation * plaquette[choice]
        dnf = dn.to(fdt)
        link = dphi[at] - TWO_PI * n[at].to(fdt)
        dS = (kappa / 2) * (-TWO_PI * dnf) * (2 * link - TWO_PI * dnf)
        accept = metropolis(u_accept[i], dS) & ~close[i]
        n[at] = n[at] + torch.where(accept, dn, 0)
        head = torch.where(accept[:, None], torch.remainder(head + moves[choice], N), head)
        disp = torch.remainder(head - tail, N)
        tally = (rows, disp[:, 0], disp[:, 1])
        hist[tally] = hist[tally] + (~close[i]).float()
        tail = torch.where(close[i][:, None], restart[i, :, :2], tail)
        head = torch.where(close[i][:, None], restart[i, :, 2:], head)
        orientation = torch.where(close[i], orients[i].to(n.dtype), orientation)
    worm = torch.cat([head, tail, orientation[:, None].long()], dim=1).to(torch.int32)
    return n, worm, hist, hist.sum(dim=(1, 2))


def replay(seed, chains, traffic, device, dtype):
    """The columns (records, chains, ...) and final fields (chains, ...) of the
    fleet's chains ``chains`` in the call with fleet seed ``seed``, as NumPy
    arrays (float columns and φ as float32)."""
    t = traffic
    if t['W'] != 1 or t['L'] % 2:
        raise ValueError('the reference replays Hammer(S, fleet=True) at W=1 and even N only')
    N, kappa = t['L'], t['kappa']
    index = torch.tensor(chains, dtype=torch.int64, device=device)
    draws = FleetDraws(seed, t['chains'], index, device)
    masks = colors(N, device)
    B = len(chains)
    phi = torch.zeros((B, 1, N, N), dtype=dtype, device=device)
    n = torch.zeros((B, 2, N, N), dtype=torch.int32, device=device)
    worm = torch.tensor([0, 0, 0, 0, 1], dtype=torch.int32, device=device).expand(B, 5)
    columns = {'Vortex_Vortex': [], 'Worm_Length': []}
    for _ in range(t['records_per_call']):
        hist = length = 0
        for _ in range(t['thin']):
            phi = site_update(phi, n, draws, masks, kappa)
            n = link_update(phi, n, draws, kappa, t['W'])
            n = exact_update(phi, n, draws, masks, kappa)
            n = cohomology_update(phi, n, draws, kappa)
            n, worm, h, moves = chunked_worm(phi, n, worm, draws.kernel_seed(), index, kappa)
            hist, length = hist + h, length + moves
        columns['Vortex_Vortex'].append((hist / t['thin']).cpu().numpy())
        columns['Worm_Length'].append((length / t['thin']).cpu().numpy())
    final = {'phi': phi.float().cpu().numpy(), 'n': n.cpu().numpy(), 'worm': worm.cpu().numpy()}
    return {k: np.stack(v) for k, v in columns.items()}, final
