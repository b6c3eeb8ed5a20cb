"""Monte-Carlo updates for the Villain action, on a batch of chains.

PyTorch counterparts of the updates of :mod:`supervillain_tpu.generators.villain`
and of its ``Hammer``.  Every step takes fields with a leading chain axis, and
the chains stay independent: each draws its own proposals and accepts on its
own.  The local updates take any dimension D and sweep every checkerboard
color of the lattice (2 at even N, 2^max(D,2) at odd N); the worms are D=2
only, as the JAX package's are.

- ``NeighborhoodUpdate`` and ``ExactNeighborhoodUpdate`` run one sweep through
  :func:`..ops.sweep.neighborhood_sweeps` in D=2, ``ClassicWorm`` one worm
  through :func:`..ops.worm.classic_worms` and ``ChunkedWorm`` its micro-moves
  through :func:`..ops.worm.chunked_worms`: on the card their CUDA kernels (B1,
  B2, K1), on the CPU their plain twins (the sweep's draws from the step's
  ``torch.Generator``, the worms' from the kernels' Philox streams, seeded
  from it).  At D >= 3 no kernel exists (the TPU kernels are D=2
  only): the neighborhood sweep runs its D-general form,
  :func:`..ops.sweep.plain_sweeps`, as PyTorch operations on the fields'
  device, so a D >= 3 chain launches no kernel.
- ``SiteUpdate``, ``LinkUpdate``, ``ExactUpdate`` and ``CohomologyUpdate`` are
  PyTorch operations on either device, as the JAX package runs them outside
  Pallas.  Their ΔS algebra is in the ``*_delta_s`` functions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import Villain
from ..ops import calculus as calc
from ..ops import kernels, shard
from ..ops.sweep import SweepDraws, neighborhood_sweeps, plain_sweeps, slab_pass, slab_residual
from ..ops.worm import chunked_worms, classic_worms
from .base import Generator, PassUpdate, metropolis, uniform_nonzero_int
from .combining import KeepEvery, Sequentially

TWO_PI = 2 * np.pi


def require_villain(action):
    if not isinstance(action, Villain):
        raise ValueError('Need a Villain action')


def require_worm_2d(action, what):
    """The plaquette worms are D=2 only, as the JAX package's are."""
    require_villain(action)
    if action.Lattice.D != 2:
        raise NotImplementedError(f'{what} is only implemented for D=2')


def _spatial(L):
    return tuple(range(-L.D, 0))


def _uniform(generator, shape, like, axis=0):
    """Uniforms in ``like``'s dtype and device, the chain axis being ``axis``."""
    return shard.rand(generator, shape, dtype=like.dtype, device=like.device, axis=axis)


# -- ΔS of each update's proposals, per site (or per link, per chain) ----------

def site_delta_s(kappa, L, r, change_phi):
    """ΔS at each site of a Δφ (B, 1, N, ..., N) on one checkerboard color, from the
    residual r = dφ − 2πn: Σ over the site's links of (κ/2)·dΔφ·(2r + dΔφ)."""
    cd = calc.d(L, 0, change_phi)
    return calc.face_sum(L, 1, (kappa / 2) * cd * (2 * r + cd))[:, 0]


def link_delta_s(kappa, dphi, n, change_n):
    """ΔS of each link's own Δn at fixed φ: −2πκ·Δn·(dφ − 2πn − πΔn)."""
    change = change_n.to(dphi.dtype)
    return (-TWO_PI * kappa * change) * (dphi - TWO_PI * n.to(dphi.dtype) - np.pi * change)


def exact_delta_s(kappa, L, dphi, n, change_z):
    """ΔS at each site of a Δn = dΔz, with Δz (B, 1, N, ..., N) on one color."""
    return calc.face_sum(L, 1, link_delta_s(kappa, dphi, n, calc.d(L, 0, change_z)))[:, 0]


def slice_delta_s(kappa, r_slice, h):
    """ΔS per chain of adding h (B,) to n_μ on a slice, from the residual's
    component μ on it, (B, k) in the slice's order: one sum over the k links,
    the same call on the same numbers however the lattice is laid out."""
    change_r = (-TWO_PI * h.to(r_slice.dtype))[:, None]
    return torch.sum((kappa / 2) * change_r * (2 * r_slice + change_r), dim=1)


def cohomology_delta_s(kappa, r_mu, mask, h):
    """ΔS per chain of adding h (B,) to n_μ on the slice ``mask`` (x_μ = 0),
    from the residual's component μ (B, N, ..., N)."""
    return slice_delta_s(kappa, r_mu[:, mask], h)


# -- the updates ------------------------------------------------------------------

class SiteUpdate(PassUpdate):
    r"""Checkerboarded Metropolis update of φ alone:
    ``Δφ_x ~ U(-interval_phi, +interval_phi)``, n fixed."""

    name = 'SiteUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_phi=np.pi):
        require_villain(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_phi = float(interval_phi)

    def begin(self, generator, cfg):
        phi, n = cfg['phi'], cfg['n']
        return {'phi': phi, 'n': n, 'r': calc.d(self.Lattice, 0, phi) - TWO_PI * n.to(phi.dtype)}

    def pass_keys(self):
        return range(self.Lattice.n_colors)

    def run_pass(self, generator, state, color):
        S, L = self.Action, self.Lattice
        phi, r = state['phi'], state['r']
        B = phi.shape[0]
        mask = shard.mask(generator, L, color, phi.device)
        prop = (2 * _uniform(generator, (B,) + L.dims, phi) - 1) * self.interval_phi
        change_phi = torch.where(mask, prop, 0)[:, None]
        dS = site_delta_s(S.kappa, L, r, change_phi)
        accept, prob = metropolis(_uniform(generator, (B,) + L.dims, phi), dS)
        accept = accept & mask
        applied = torch.where(accept, change_phi[:, 0], 0)[:, None]
        state = state | {'phi': phi + applied, 'r': r + calc.d(L, 0, applied)}
        return (state, shard.site_sum(generator, accept, L.D),
                shard.site_sum(generator, torch.where(mask, prob, 0), L.D))

    def tally(self, stats, chains, accepted, acceptance):
        L = self.Lattice
        return self._tally(stats, chains, accepted, L.sites, acceptance / L.sites)


class LinkUpdate(PassUpdate):
    r"""Simultaneous Metropolis update of every link's n alone:
    ``Δn_ℓ ∈ W·(±{1..interval_n})``, φ fixed."""

    name = 'LinkUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_n=1):
        require_villain(action)
        if action.W == float('inf'):
            raise ValueError('LinkUpdate changes dn by multiples of W; undefined at W=inf.')
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_n = int(interval_n)

    def begin(self, generator, cfg):
        return {'phi': cfg['phi'], 'n': cfg['n']}

    def pass_keys(self):
        return (None,)

    def run_pass(self, generator, state, key):
        S, L = self.Action, self.Lattice
        phi, n = state['phi'], state['n']
        change_n = S.W * uniform_nonzero_int(generator, n.shape, self.interval_n,
                                             dtype=n.dtype, device=n.device)
        dS = link_delta_s(S.kappa, calc.d(L, 0, phi), n, change_n)
        accept, prob = metropolis(_uniform(generator, n.shape, phi), dS)
        state = state | {'n': n + torch.where(accept, change_n, 0)}
        return (state, shard.site_sum(generator, accept, L.D + 1),
                shard.site_sum(generator, prob, L.D + 1))

    def tally(self, stats, chains, accepted, acceptance):
        L = self.Lattice
        return self._tally(stats, chains, accepted, L.links, acceptance / L.links)


class ExactUpdate(PassUpdate):
    r"""Coordinated update ``Δn = dz`` for an integer 0-form z on one color, so
    that ``d(Δn) = 0``: preserves dn exactly (works at W=∞)."""

    name = 'ExactUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_z=1):
        require_villain(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_z = int(interval_z)

    def begin(self, generator, cfg):
        phi = cfg['phi']
        return {'phi': phi, 'n': cfg['n'], 'dphi': calc.d(self.Lattice, 0, phi)}

    def pass_keys(self):
        return range(self.Lattice.n_colors)

    def run_pass(self, generator, state, color):
        S, L = self.Action, self.Lattice
        phi, n, dphi = state['phi'], state['n'], state['dphi']
        B = phi.shape[0]
        mask = shard.mask(generator, L, color, phi.device)
        z = uniform_nonzero_int(generator, (B,) + L.dims, self.interval_z, dtype=n.dtype,
                                device=n.device)
        change_z = torch.where(mask, z, 0)[:, None]
        dS = exact_delta_s(S.kappa, L, dphi, n, change_z)
        accept, prob = metropolis(_uniform(generator, (B,) + L.dims, phi), dS)
        accept = accept & mask
        state = state | {'n': n + calc.d(L, 0, torch.where(accept, change_z[:, 0], 0)[:, None])}
        return (state, shard.site_sum(generator, accept, L.D),
                shard.site_sum(generator, torch.where(mask, prob, 0), L.D))

    def tally(self, stats, chains, accepted, acceptance):
        L = self.Lattice
        return self._tally(stats, chains, accepted, L.sites, acceptance / L.sites)


class CohomologyUpdate(Generator):
    r"""Winding-sector update: for each direction μ, each chain proposes adding
    its own ``h_μ ∈ ±{1..interval_h}`` to ``n_μ`` on the slice ``x_μ = 0``.
    ``d(Δn) = 0`` exactly, and the winding number w_μ changes by h_μ.  A step
    is :meth:`slices`, :meth:`decide` and :meth:`apply`, so that a chain × space
    mesh (:mod:`..parallel.space`) gathers only the slices."""

    name = 'CohomologyUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_h=1):
        require_villain(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_h = int(interval_h)
        D = self.Lattice.D
        masks = np.zeros((D,) + self.Lattice.dims, dtype=bool)
        for mu in range(D):         # sites with x_μ = 0
            masks[(mu,) + tuple(0 if i == mu else slice(None) for i in range(D))] = True
        self._slice_masks = masks
        self._on_device = {}

    def _masks(self, device, slab=None):
        """The slices' masks on ``device``, or a slab's own columns of them."""
        if device not in self._on_device:
            self._on_device[device] = torch.as_tensor(self._slice_masks, device=device)
        masks = self._on_device[device]
        return masks if slab is None else masks[..., slab.col0:slab.col0 + slab.width]

    def slices(self, cfg, slab=None):
        """The residual's component μ on the slice x_μ = 0 for each μ, (B, k)
        contiguous, in the slice's order; of a slab's own columns (D=2), its
        part of each slice (k = 0 where it holds none), the slices joined in
        slab order being the whole ones."""
        phi, n = cfg['phi'], cfg['n']
        D, B = self.Lattice.D, phi.shape[0]
        r = calc.d(self.Lattice, 0, phi) - TWO_PI * n.to(phi.dtype)
        return [r.new_zeros((B, 0)) if slab is not None and mu == D - 1 and slab.col0 else
                r[:, mu].select(1 + mu, 0).reshape(B, -1).contiguous() for mu in range(D)]

    def decide(self, generator, slices, idt):
        """Each μ's proposal h (dtype ``idt``), Metropolis accept and
        probability per chain, from the whole ``slices``, drawn in order."""
        decisions = []
        for r_slice in slices:
            B = r_slice.shape[0]
            h = uniform_nonzero_int(generator, (B,), self.interval_h, dtype=idt,
                                    device=r_slice.device)
            dS = slice_delta_s(self.Action.kappa, r_slice, h)
            decisions.append((h, *metropolis(_uniform(generator, (B,), r_slice), dS)))
        return decisions

    def apply(self, cfg, decisions, slab=None):
        """``cfg`` with each accepted h_μ added to n_μ on the slice (a slab's
        own columns of it)."""
        n = cfg['n'].clone()
        masks = self._masks(n.device, slab)
        for mu, (h, accept, _) in enumerate(decisions):
            dh = torch.where(accept, h, 0).reshape((-1,) + (1,) * self.Lattice.D)
            n[:, mu] += torch.where(masks[mu], dh, 0)
        return cfg | {'n': n}

    def tally(self, stats, decisions):
        D = self.Lattice.D
        accepted = sum(accept.to(prob.dtype) for _, accept, prob in decisions)
        acceptance = sum(prob for _, _, prob in decisions)
        return self._tally(stats, decisions[0][1].shape[0], accepted, D, acceptance / D)

    def step(self, generator, cfg, stats):
        decisions = self.decide(generator, self.slices(cfg), cfg['n'].dtype)
        return self.apply(cfg, decisions), self.tally(stats, decisions), {}


def run_sweeps(phi, n, *, kappa, W, interval_phi, interval_n, sweeps, p_n, generator):
    """:func:`..ops.sweep.neighborhood_sweeps` in D=2 (B1 on the card); at D >= 3,
    where no kernel exists, its D-general plain form on the fields' device
    with draws from ``generator``."""
    D = phi.dim() - 2
    if D == 2:
        return neighborhood_sweeps(phi, n, kappa=kappa, W=W, interval_phi=interval_phi,
                                   interval_n=interval_n, sweeps=sweeps, p_n=p_n,
                                   generator=generator)
    draws = SweepDraws(generator, B=phi.shape[0], N=phi.shape[-1], interval_phi=interval_phi,
                       interval_n=interval_n, p_n=p_n, zmode=W == float('inf'), fdt=phi.dtype,
                       idt=n.dtype, device=phi.device, D=D)
    return plain_sweeps(phi, n, kappa=kappa, W=W, sweeps=sweeps, draws=draws)


class NeighborhoodUpdate(PassUpdate):
    r"""Simultaneous site-neighborhood update: Δφ at each same-color site plus
    ``Δn ∈ W·{-interval_n..interval_n}`` on the links touching it (zero-inflated
    with probability ``p_n`` of a nonzero Δn when given): one sweep of
    :func:`..ops.sweep.neighborhood_sweeps` in D=2 (B1 on the card), of its
    D-general PyTorch form :func:`..ops.sweep.plain_sweeps` at D >= 3.  On a
    chain × space mesh a slab runs its passes through
    :func:`..ops.sweep.slab_pass`, B1's slab entry on the card.

    The stats' ``acceptance`` tallies the realized accepted fraction."""

    name = 'NeighborhoodUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_phi=np.pi, interval_n=1, p_n=None):
        require_villain(action)
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
        phi, n, accepted, _ = run_sweeps(cfg['phi'], cfg['n'], kappa=self.Action.kappa,
                                         W=self._kernel_W(), interval_phi=self.interval_phi,
                                         interval_n=self.interval_n, sweeps=1, p_n=self.p_n,
                                         generator=generator)
        return cfg | {'phi': phi, 'n': n}, self.tally(stats, phi.shape[0], accepted, 0), {}

    # The passes of one sweep on a slab (the step above runs the whole torus).
    def begin(self, generator, cfg):
        phi, n = cfg['phi'], cfg['n']
        state = {'phi': phi, 'n': n, 'r': slab_residual(phi, n)}
        if phi.device.type == 'cuda':
            state['seed'] = kernels.seed_from(generator)
        return state

    def pass_keys(self):
        return range(self.Lattice.n_colors)

    def run_pass(self, generator, state, color):
        phi, n, r, accepted = slab_pass(
            state['phi'], state['n'], state['r'], color, kappa=self.Action.kappa,
            W=self._kernel_W(), interval_phi=self.interval_phi, interval_n=self.interval_n,
            p_n=self.p_n, generator=generator, seed=state.get('seed'))
        return state | {'phi': phi, 'n': n, 'r': r}, accepted, 0

    def tally(self, stats, chains, accepted, acceptance):
        L = self.Lattice
        return self._tally(stats, chains, accepted, L.sites, accepted / L.sites)


class ExactNeighborhoodUpdate(NeighborhoodUpdate):
    r"""Compound (Δφ, Δz) site update with Δn = d(Δz): preserves dn exactly at
    every W including W=∞ (the sweeps' z-mode).  ``p_z`` zero-inflates Δz."""

    name = 'ExactNeighborhoodUpdate'

    def __init__(self, action, interval_phi=np.pi, interval_z=1, p_z=None):
        require_villain(action)
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
        require_worm_2d(action, 'ClassicWorm')
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
    fleet's step independent of its slowest chain.  One step is one call of
    :func:`..ops.worm.chunked_worms` (K1 on the card; on the CPU its plain
    twin on the kernel's Philox stream, seeded from the step's generator).
    Tallies the same
    inline ``Vortex_Vortex`` and ``Worm_Length`` (moves tallied this step);
    ``sweeps`` in the stats counts completed worms."""

    name = 'ClassicWorm'  # same transition-kernel family; same stats tag
    fields = ('phi', 'n')

    def __init__(self, action, moves_per_step=8):
        require_worm_2d(action, 'ChunkedWorm')
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
        phi = cfg['phi']
        n, worm, hist, length, closes = chunked_worms(
            phi, cfg['n'], cfg['worm'], kappa=self.Action.kappa, moves=self.moves_per_step,
            generator=generator)
        stats = self._tally(stats, phi.shape[0], length, length, 1.0, sweeps=closes)
        return (cfg | {'n': n, 'worm': worm}, stats,
                {'Vortex_Vortex': hist, 'Worm_Length': length})

    def report(self, stats):
        return super().report(stats).replace(self.name, 'ChunkedWorm', 1)


def Hammer(S, worms=1, worm_moves=None, fleet=False, max_worm_moves=None):
    """Ergodic composite for the Villain action:
    Sequentially(Site, [Link if W<∞], Exact, Cohomology, [Worm if D=2]).  At
    D >= 3 no step launches a kernel.

    ``worm_moves``: at W=1, a :class:`ChunkedWorm` of that many micro-moves per
    step in place of the :class:`ClassicWorm`.  ``fleet``: a worm whose step
    time is bounded over many chains: :class:`ChunkedWorm` (64 micro-moves) at
    W=1, :class:`ClassicWorm` with ``max_moves=max_worm_moves`` (default
    8·sites) at W>1.  ``max_worm_moves`` also caps the worm without ``fleet``."""
    require_villain(S)
    parts = [SiteUpdate(S)]
    if S.W < float('inf'):
        parts.append(LinkUpdate(S))
    parts.append(ExactUpdate(S))
    parts.append(CohomologyUpdate(S))
    if S.Lattice.D == 2:
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
