"""Monte-Carlo updates for the Villain action (D=2), on a batch of chains.

PyTorch counterparts of the updates of :mod:`supervillain_tpu.generators.villain`
and of its ``Hammer``.  Every step takes fields with a leading chain axis, and
the chains stay independent: each draws its own proposals and accepts on its
own.

- ``NeighborhoodUpdate`` and ``ExactNeighborhoodUpdate`` run one sweep through
  :func:`..ops.sweep.neighborhood_sweeps`, and ``ClassicWorm`` one worm through
  :func:`..ops.worm.classic_worms`: on the card their CUDA kernels, on the CPU
  their plain twins with draws from the step's ``torch.Generator``.
- ``SiteUpdate``, ``LinkUpdate``, ``ExactUpdate``, ``CohomologyUpdate`` and
  ``ChunkedWorm`` are PyTorch operations on either device, as the JAX package
  runs them outside Pallas.  Their ΔS algebra is in the ``*_delta_s`` functions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import Villain
from ..ops import calculus as calc
from ..ops.sweep import neighborhood_sweeps
from ..ops.worm import _LINK_DIR, _LINK_OFF, _MOVES, _PLAQUETTE, classic_worms
from .base import Generator, metropolis, uniform_nonzero_int
from .combining import KeepEvery, Sequentially

TWO_PI = 2 * np.pi


def require_villain_2d(action):
    if not isinstance(action, Villain):
        raise ValueError('Need a Villain action')
    if action.Lattice.D != 2:
        raise NotImplementedError('The port implements the Villain updates for D=2')


def _uniform(generator, shape, like):
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


# -- ΔS of each update's proposals, per site (or per link, per chain) ----------

def site_delta_s(kappa, L, r, change_phi):
    """ΔS at each site of a Δφ (B, 1, N, N) on one checkerboard color, from the
    residual r = dφ − 2πn: Σ over the site's links of (κ/2)·dΔφ·(2r + dΔφ)."""
    cd = calc.d(L, 0, change_phi)
    return calc.face_sum(L, 1, (kappa / 2) * cd * (2 * r + cd))[:, 0]


def link_delta_s(kappa, dphi, n, change_n):
    """ΔS of each link's own Δn at fixed φ: −2πκ·Δn·(dφ − 2πn − πΔn)."""
    change = change_n.to(dphi.dtype)
    return (-TWO_PI * kappa * change) * (dphi - TWO_PI * n.to(dphi.dtype) - np.pi * change)


def exact_delta_s(kappa, L, dphi, n, change_z):
    """ΔS at each site of a Δn = dΔz, with Δz (B, 1, N, N) on one color."""
    return calc.face_sum(L, 1, link_delta_s(kappa, dphi, n, calc.d(L, 0, change_z)))[:, 0]


def cohomology_delta_s(kappa, r_mu, mask, h):
    """ΔS per chain of adding h (B,) to n_μ on the slice ``mask`` (x_μ = 0),
    from the residual's component μ (B, N, N)."""
    change_r = (-TWO_PI * h.to(r_mu.dtype))[:, None, None]
    return torch.sum(torch.where(mask, (kappa / 2) * change_r * (2 * r_mu + change_r), 0),
                     dim=(-2, -1))


# -- the updates ------------------------------------------------------------------

class SiteUpdate(Generator):
    r"""Checkerboarded Metropolis update of φ alone:
    ``Δφ_x ~ U(-interval_phi, +interval_phi)``, n fixed."""

    name = 'SiteUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_phi=np.pi):
        require_villain_2d(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_phi = float(interval_phi)

    def step(self, generator, cfg, stats):
        S, L = self.Action, self.Lattice
        phi, n = cfg['phi'], cfg['n']
        B = phi.shape[0]
        r = calc.d(L, 0, phi) - TWO_PI * n.to(phi.dtype)
        accepted = acceptance = 0
        for color in range(L.n_colors):
            mask = L.mask(color, phi.device)
            prop = (2 * _uniform(generator, (B,) + L.dims, phi) - 1) * self.interval_phi
            change_phi = torch.where(mask, prop, 0)[:, None]
            dS = site_delta_s(S.kappa, L, r, change_phi)
            accept, prob = metropolis(_uniform(generator, (B,) + L.dims, phi), dS)
            accept = accept & mask
            applied = torch.where(accept, change_phi[:, 0], 0)[:, None]
            phi = phi + applied
            r = r + calc.d(L, 0, applied)
            accepted = accepted + accept.sum(dim=(-2, -1))
            acceptance = acceptance + torch.where(mask, prob, 0).sum(dim=(-2, -1))
        stats = self._tally(stats, B, accepted, L.sites, acceptance / L.sites)
        return cfg | {'phi': phi}, stats, {}


class LinkUpdate(Generator):
    r"""Simultaneous Metropolis update of every link's n alone:
    ``Δn_ℓ ∈ W·(±{1..interval_n})``, φ fixed."""

    name = 'LinkUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_n=1):
        require_villain_2d(action)
        if action.W == float('inf'):
            raise ValueError('LinkUpdate changes dn by multiples of W; undefined at W=inf.')
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_n = int(interval_n)

    def step(self, generator, cfg, stats):
        S, L = self.Action, self.Lattice
        phi, n = cfg['phi'], cfg['n']
        change_n = S.W * uniform_nonzero_int(generator, n.shape, self.interval_n,
                                             dtype=n.dtype, device=n.device)
        dS = link_delta_s(S.kappa, calc.d(L, 0, phi), n, change_n)
        accept, prob = metropolis(_uniform(generator, n.shape, phi), dS)
        n = n + torch.where(accept, change_n, 0)
        stats = self._tally(stats, n.shape[0], accept.sum(dim=(1, 2, 3)), L.links,
                            prob.mean(dim=(1, 2, 3)))
        return cfg | {'n': n}, stats, {}


class ExactUpdate(Generator):
    r"""Coordinated update ``Δn = dz`` for an integer 0-form z on one color, so
    that ``d(Δn) = 0``: preserves dn exactly (works at W=∞)."""

    name = 'ExactUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_z=1):
        require_villain_2d(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_z = int(interval_z)

    def step(self, generator, cfg, stats):
        S, L = self.Action, self.Lattice
        phi, n = cfg['phi'], cfg['n']
        B = phi.shape[0]
        dphi = calc.d(L, 0, phi)
        accepted = acceptance = 0
        for color in range(L.n_colors):
            mask = L.mask(color, phi.device)
            z = uniform_nonzero_int(generator, (B,) + L.dims, self.interval_z, dtype=n.dtype,
                                    device=n.device)
            change_z = torch.where(mask, z, 0)[:, None]
            dS = exact_delta_s(S.kappa, L, dphi, n, change_z)
            accept, prob = metropolis(_uniform(generator, (B,) + L.dims, phi), dS)
            accept = accept & mask
            n = n + calc.d(L, 0, torch.where(accept, change_z[:, 0], 0)[:, None])
            accepted = accepted + accept.sum(dim=(-2, -1))
            acceptance = acceptance + torch.where(mask, prob, 0).sum(dim=(-2, -1))
        stats = self._tally(stats, B, accepted, L.sites, acceptance / L.sites)
        return cfg | {'n': n}, stats, {}


class CohomologyUpdate(Generator):
    r"""Winding-sector update: for each direction μ, each chain proposes adding
    its own ``h_μ ∈ ±{1..interval_h}`` to ``n_μ`` on the slice ``x_μ = 0``.
    ``d(Δn) = 0`` exactly, and the winding number w_μ changes by h_μ."""

    name = 'CohomologyUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_h=1):
        require_villain_2d(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_h = int(interval_h)
        masks = np.zeros((2,) + self.Lattice.dims, dtype=bool)
        masks[0, 0, :] = True       # sites with x_0 = 0
        masks[1, :, 0] = True       # sites with x_1 = 0
        self._slice_masks = masks
        self._on_device = {}

    def step(self, generator, cfg, stats):
        S, L = self.Action, self.Lattice
        phi, n = cfg['phi'], cfg['n']
        B = phi.shape[0]
        if phi.device not in self._on_device:
            self._on_device[phi.device] = torch.as_tensor(self._slice_masks, device=phi.device)
        masks = self._on_device[phi.device]
        r = calc.d(L, 0, phi) - TWO_PI * n.to(phi.dtype)
        accepted = acceptance = 0
        for mu in range(L.D):
            h = uniform_nonzero_int(generator, (B,), self.interval_h, dtype=n.dtype,
                                    device=n.device)
            dS = cohomology_delta_s(S.kappa, r[:, mu], masks[mu], h)
            accept, prob = metropolis(_uniform(generator, (B,), phi), dS)
            dh = torch.where(accept, h, 0)[:, None, None]
            n = n.clone()
            n[:, mu] += torch.where(masks[mu], dh, 0)
            r = r.clone()
            r[:, mu] += torch.where(masks[mu], -TWO_PI * dh.to(r.dtype), 0)
            accepted = accepted + accept.to(phi.dtype)
            acceptance = acceptance + prob
        stats = self._tally(stats, B, accepted, L.D, acceptance / L.D)
        return cfg | {'n': n}, stats, {}


class NeighborhoodUpdate(Generator):
    r"""Simultaneous site-neighborhood update: Δφ at each same-color site plus
    ``Δn ∈ W·{-interval_n..interval_n}`` on the links touching it (zero-inflated
    with probability ``p_n`` of a nonzero Δn when given): one sweep of
    :func:`..ops.sweep.neighborhood_sweeps` (B1 on the card).

    The stats' ``acceptance`` tallies the realized accepted fraction."""

    name = 'NeighborhoodUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_phi=np.pi, interval_n=1, p_n=None):
        require_villain_2d(action)
        if action.W == float('inf'):
            raise ValueError('NeighborhoodUpdate offers Δn in multiples of W; undefined at W=inf.')
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_phi = float(interval_phi)
        self.interval_n = int(interval_n)
        self.p_n = None if p_n is None else float(p_n)

    def _kernel_W(self):
        return self.Action.W

    def step(self, generator, cfg, stats):
        L = self.Lattice
        phi, n, accepted, _ = neighborhood_sweeps(
            cfg['phi'], cfg['n'], kappa=self.Action.kappa, W=self._kernel_W(),
            interval_phi=self.interval_phi, interval_n=self.interval_n, sweeps=1, p_n=self.p_n,
            generator=generator)
        stats = self._tally(stats, phi.shape[0], accepted, L.sites, accepted / L.sites)
        return cfg | {'phi': phi, 'n': n}, stats, {}


class ExactNeighborhoodUpdate(NeighborhoodUpdate):
    r"""Compound (Δφ, Δz) site update with Δn = d(Δz): preserves dn exactly at
    every W including W=∞ (the sweeps' z-mode).  ``p_z`` zero-inflates Δz."""

    name = 'ExactNeighborhoodUpdate'

    def __init__(self, action, interval_phi=np.pi, interval_z=1, p_z=None):
        require_villain_2d(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_phi = float(interval_phi)
        self.interval_n = int(interval_z)
        self.p_n = None if p_z is None else float(p_z)

    def _kernel_W(self):
        return float('inf')

    # The JAX package's names of the Δz interval and zero-inflation.
    interval_z = property(lambda self: self.interval_n)
    p_z = property(lambda self: self.p_n)


class _WormReport:
    def report(self, stats):
        s = {k: float(v) for k, v in stats[self.name].items()}
        worms = max(s['sweeps'], 1.0)
        line = f'{self.name}: {worms:.0f} worms, mean length {s["accepted"] / worms:.3f}'
        truncated = worms - s['acceptance']
        if getattr(self, 'max_moves', None) is not None and truncated > 0.5:
            line += f' ({truncated:.0f} truncated at max_moves={self.max_moves})'
        return line


class ClassicWorm(_WormReport, Generator):
    r"""Prokof'ev–Svistunov worm on the plaquettes, one per chain and step:
    :func:`..ops.worm.classic_worms` (B2 on the card).  Tallies the inline
    ``Vortex_Vortex`` histogram and ``Worm_Length``.  ``max_moves`` caps a
    worm; an unclosed worm is rolled back at W≠1 and kept at W=1.  Not
    ergodic alone (never changes φ or dn)."""

    name = 'ClassicWorm'
    fields = ('phi', 'n')

    def __init__(self, action, max_moves=None):
        require_villain_2d(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.max_moves = None if max_moves is None else int(max_moves)

    def inline_shapes(self):
        return {'Vortex_Vortex': self.Lattice.dims, 'Worm_Length': ()}

    def step(self, generator, cfg, stats):
        phi = cfg['phi']
        n, hist, length, truncated = classic_worms(
            phi, cfg['n'], kappa=self.Action.kappa, W=self.Action.W, worms=1,
            max_worm_moves=self.max_moves, generator=generator)
        stats = self._tally(stats, phi.shape[0], length, length, 1 - truncated)
        return cfg | {'n': n}, stats, {'Vortex_Vortex': hist, 'Worm_Length': length}


class ChunkedWorm(_WormReport, Generator):
    r"""The classic worm's move sequence time-sliced into exactly
    ``moves_per_step`` micro-moves per step, with each chain's open worm (head,
    tail, orientation) carried in the configuration's ``'worm'`` (B, 5) between
    steps.  When the 20% close move fires, a new worm starts at once (fresh
    tail, head and orientation) within the same chunk.

    Villain D=2, **W=1 only**: there every configuration is valid and each
    micro-move keeps e^{-S} × uniform(head, tail) stationary, so emitting at a
    fixed stride is unbiased.  A fixed trip count over the chain axis makes a
    fleet's step independent of its slowest chain.  It runs as PyTorch
    operations (tens of launches a micro-move on the card).  Tallies the same
    inline ``Vortex_Vortex`` and ``Worm_Length`` (moves tallied this step);
    ``sweeps`` in the stats counts completed worms."""

    name = 'ClassicWorm'  # same transition-kernel family; same stats tag
    fields = ('phi', 'n')

    def __init__(self, action, moves_per_step=8):
        require_villain_2d(action)
        if action.W != 1:
            raise ValueError(
                'ChunkedWorm emits on a fixed stride, which is only unbiased at W=1 '
                '(open worms are valid configurations there); use ClassicWorm for W>1.')
        self.Action = action
        self.Lattice = action.Lattice
        self.moves_per_step = int(moves_per_step)

    def inline_shapes(self):
        return {'Vortex_Vortex': self.Lattice.dims, 'Worm_Length': ()}

    def prepare(self, cfg):
        if 'worm' in cfg:
            return cfg
        # Head = tail = origin, +1 orientation: an initial condition, not a move.
        B = cfg['n'].shape[0]
        worm = torch.tensor([0, 0, 0, 0, 1], dtype=torch.int32, device=cfg['n'].device)
        return cfg | {'worm': worm.expand(B, 5).contiguous()}

    def step(self, generator, cfg, stats):
        S, L = self.Action, self.Lattice
        N, T = L.N, self.moves_per_step
        phi, n = cfg['phi'], cfg['n']
        B, dev = phi.shape[0], phi.device
        dphi = calc.d(L, 0, phi).reshape(-1)
        flat = n.reshape(-1).clone()
        worm = cfg['worm'].long()
        head, tail, orientation = worm[:, :2], worm[:, 2:4], worm[:, 4].to(n.dtype)

        u = _uniform(generator, (T, 2, B), phi)
        choices = torch.randint(0, 4, (T, B), generator=generator, device=dev)
        restarts = torch.randint(0, N, (T, B, 4), generator=generator, device=dev)
        orients = 2 * torch.randint(0, 2, (T, B), generator=generator, device=dev,
                                    dtype=n.dtype) - 1
        moves = torch.tensor(_MOVES, device=dev)
        link_dir = torch.tensor(_LINK_DIR, device=dev)
        link_off = torch.tensor(_LINK_OFF, device=dev)
        plaquette = torch.tensor(_PLAQUETTE, dtype=n.dtype, device=dev)
        base = torch.arange(B, device=dev) * (2 * N * N)
        hist = torch.zeros(B * N * N, dtype=phi.dtype, device=dev)
        closes = torch.zeros(B, dtype=phi.dtype, device=dev)

        for i in range(T):
            close_now = u[i, 0] >= 0.8                   # W=1: always closed
            choice = choices[i]
            next_head = torch.remainder(head + moves[choice], N)
            lpos = torch.remainder(head + link_off[choice], N)
            at = base + link_dir[choice] * (N * N) + lpos[:, 0] * N + lpos[:, 1]
            dn = orientation * plaquette[choice]
            dnf = dn.to(phi.dtype)
            link = dphi[at] - TWO_PI * flat[at].to(phi.dtype)
            dS = (S.kappa / 2) * (-TWO_PI * dnf) * (2 * link - TWO_PI * dnf)
            accept = (u[i, 1] < torch.clamp(torch.exp(-dS), max=1.0)) & ~close_now
            flat.index_add_(0, at, torch.where(accept, dn, 0))
            head = torch.where(accept[:, None], next_head, head)
            disp = torch.remainder(head - tail, N)
            hist.index_add_(0, base // 2 + disp[:, 0] * N + disp[:, 1], (~close_now).to(phi.dtype))
            # Close and restart: a fresh worm within the same chunk.
            tail = torch.where(close_now[:, None], restarts[i, :, :2], tail)
            head = torch.where(close_now[:, None], restarts[i, :, 2:], head)
            orientation = torch.where(close_now, orients[i], orientation)
            closes = closes + close_now.to(phi.dtype)

        hist = hist.reshape(B, N, N)
        length = hist.sum(dim=(1, 2))
        worm = torch.cat([head, tail, orientation[:, None].long()], dim=1).to(torch.int32)
        stats = self._tally(stats, B, length, length, 1.0, sweeps=closes)
        return (cfg | {'n': flat.reshape(n.shape), 'worm': worm}, stats,
                {'Vortex_Vortex': hist, 'Worm_Length': length})

    def report(self, stats):
        return super().report(stats).replace(self.name, 'ChunkedWorm', 1)


def Hammer(S, worms=1, worm_moves=None, fleet=False, max_worm_moves=None):
    """Ergodic composite for the Villain action:
    Sequentially(Site, [Link if W<∞], Exact, Cohomology, Worm).

    ``worm_moves``: at W=1, a :class:`ChunkedWorm` of that many micro-moves per
    step in place of the :class:`ClassicWorm`.  ``fleet``: a worm whose step
    time is bounded over many chains: :class:`ChunkedWorm` (64 micro-moves) at
    W=1, :class:`ClassicWorm` with ``max_moves=max_worm_moves`` (default
    8·sites) at W>1.  ``max_worm_moves`` also caps the worm without ``fleet``."""
    require_villain_2d(S)
    parts = [SiteUpdate(S)]
    if S.W < float('inf'):
        parts.append(LinkUpdate(S))
    parts.append(ExactUpdate(S))
    parts.append(CohomologyUpdate(S))
    if worm_moves is not None and S.W == 1:
        parts.append(ChunkedWorm(S, moves_per_step=worm_moves))
    elif fleet and S.W == 1:
        parts.append(ChunkedWorm(S, moves_per_step=64))
    else:
        cap = max_worm_moves
        if fleet and cap is None:
            cap = 8 * S.Lattice.sites
        worm = ClassicWorm(S, max_moves=cap)
        parts.append(KeepEvery(worms, worm) if worms > 1 else worm)
    return Sequentially(parts)
