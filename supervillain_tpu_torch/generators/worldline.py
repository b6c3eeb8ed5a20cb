"""Monte-Carlo updates for the Worldline action, on a batch of chains.

PyTorch counterparts of the updates of :mod:`supervillain_tpu.generators.worldline`
and of its ``Hammer``.  Every step takes fields with a leading chain axis.
``VortexUpdate``, ``CoexactUpdate`` and ``WrappingUpdate`` run the passes of
:mod:`..ops.worldline` and ``PlaquetteUpdate`` its own, in any dimension D, as
PyTorch operations on either device with draws from the step's
``torch.Generator`` (the JAX package runs them outside Pallas; the kernel B4
fuses the first three, so none is a kernel's function alone).  They sweep
every checkerboard color of the lattice: 2 at even N, 2^max(D,2) at odd N.
``ClassicWorm`` runs one worm per chain through
:func:`..ops.worldline_worm.worldline_worms` in D=2 (the CUDA kernel B5 on the
card, its plain twin on the CPU) and through
:func:`..ops.worldline_worm.worldline_worms_general` at D >= 3 (the CUDA
kernel K2 on the card; on the CPU the D-general plain twin on K2's stream).
"""

from __future__ import annotations

import torch

from ..models import Worldline
from ..ops import calculus as calc
from ..ops import shard
from ..ops.worldline import (WorldlineSweepDraws, coexact_pass, inverse_w, on_component, passes,
                             residual, vortex_pass, wrapping_pass)
from ..ops.worldline_worm import worldline_worms, worldline_worms_general
from ..device import float_dtype_of
from ..tracing import count_on_device, recording
from .base import Generator, PassUpdate, metropolis
from .combining import KeepEvery, Sequentially
from .villain import _WormReport


def require_worldline(action):
    if not isinstance(action, Worldline):
        raise ValueError('Need a Worldline action')


def require_worldline_2d(action, what):
    """The fused worm kernels are D=2 only, as the TPU kernels are."""
    require_worldline(action)
    if action.Lattice.D != 2:
        raise NotImplementedError(f'{what} is only implemented for D=2')


class _LocalUpdate(Generator):
    """A checkerboarded local update of a batch of chains, with the draws of
    its passes from :class:`..ops.worldline.WorldlineSweepDraws`."""

    fields = ('m', 'v')

    def __init__(self, action, interval_v=1, interval_t=1, interval_w=1):
        require_worldline(action)
        self.Action = action
        self.Lattice = action.Lattice
        # At W=∞ the vortex proposal is continuous U(-interval_v, +interval_v).
        self.interval_v = float(interval_v) if action.W == float('inf') else int(interval_v)
        self.interval_t = int(interval_t)
        self.interval_w = int(interval_w)

    def _proposals(self):
        return self.Lattice.cells_of_degree[2]

    def _draws(self, generator, m, v):
        L = self.Lattice
        return WorldlineSweepDraws(
            generator, B=m.shape[0], N=L.N, interval_v=self.interval_v,
            interval_t=self.interval_t, interval_w=self.interval_w,
            winf=self.Action.W == float('inf'), fdt=float_dtype_of(v), idt=m.dtype,
            device=m.device, D=L.D)

    def tally(self, stats, chains, accepted, acceptance):
        proposals = self._proposals()
        return self._tally(stats, chains, accepted, proposals, accepted / proposals)


class _PlaquettePasses(_LocalUpdate, PassUpdate):
    """Passes over the plaquettes of one kind (``kind``), color by color and
    component by component, with the link residual u carried between them."""

    kind = None

    def begin(self, generator, cfg):
        m, v = cfg['m'], cfg['v']
        return {'m': m, 'v': v, 'u': residual(m, v, self.Action.W)}

    def pass_keys(self):
        return [(color, comp) for kind, color, comp in passes(self.Lattice) if kind == self.kind]

    def run_pass(self, generator, state, key):
        color, comp = key
        m, v, u = state['m'], state['v'], state['u']
        draws = self._draws(generator, m, v)(self.kind, color)
        slab = shard.slab_of(generator)
        if self.kind == 'vortex':
            v, u, accepted = vortex_pass(v, u, color, draws, kappa=self.Action.kappa,
                                         W=self.Action.W, comp=comp, slab=slab)
        else:
            m, u, accepted = coexact_pass(m, u, color, draws, kappa=self.Action.kappa,
                                          comp=comp, slab=slab)
        return {'m': m, 'v': v, 'u': u}, accepted.to(float_dtype_of(v)), 0


class VortexUpdate(_PlaquettePasses):
    r"""Metropolis update of v alone, per checkerboard color and 2-form
    component: ``Δv ∈ ±{1..interval_v}`` (finite W) or
    ``U(-interval_v, +interval_v)`` (W=∞).  The stats' ``acceptance`` tallies
    the realized accepted fraction."""

    name = 'VortexUpdate'
    kind = 'vortex'

    def __init__(self, action, interval_v=1):
        super().__init__(action, interval_v=interval_v)


class CoexactUpdate(_PlaquettePasses):
    r"""Coordinated update ``Δm = δt`` with t an integer 2-form on one color and
    component, so ``δ(Δm) = δ²t = 0`` and the constraint survives."""

    name = 'CoexactUpdate'
    kind = 'coexact'

    def __init__(self, action, interval_t=1):
        super().__init__(action, interval_t=interval_t)


class WrappingUpdate(_LocalUpdate):
    r"""Coordinated ``Δm ∈ ±{1..interval_w}`` on entire straight cycles around
    the torus, one proposal per direction μ and perpendicular position
    (D·N^(D−1) cycles): the only local update that changes the wrapping.  Its
    ΔS sums along whole cycles, so a chain × space mesh runs it on the
    gathered chain (:mod:`..parallel.space`)."""

    name = 'WrappingUpdate'

    def __init__(self, action, interval_w=1):
        super().__init__(action, interval_w=interval_w)

    def _proposals(self):
        L = self.Lattice
        return L.D * L.N ** (L.D - 1)

    def step(self, generator, cfg, stats):
        m, v = cfg['m'], cfg['v']
        draws = self._draws(generator, m, v)
        m, u, accepted = wrapping_pass(m, residual(m, v, self.Action.W),
                                       [draws('wrapping', mu) for mu in range(self.Lattice.D)],
                                       kappa=self.Action.kappa)
        stats = self.tally(stats, m.shape[0], accepted.to(float_dtype_of(v)), 0)
        return cfg | {'m': m}, stats, {}


def plaquette_delta_s(kappa, L, f, t, change_v, W, comp=0):
    """ΔS at each plaquette of component ``comp`` of a PlaquetteUpdate proposal
    on one color: the boundary change δt and Δv (each a 2-form (B, C(D,2), N,
    ..., N)) change the links' residual f = m − δv/_W by δt − δΔv/_W."""
    change_f = calc.delta(L, 2, t).to(f.dtype) - calc.delta(L, 2, change_v).to(f.dtype) * inverse_w(W)
    return calc.coface_sum(L, 1, (0.5 / kappa) * change_f * (2 * f + change_f))[:, comp]


class PlaquetteUpdate(PassUpdate):
    r"""Coordinated ±1 on the 4 boundary links of each plaquette (Δm = δt) together
    with ``Δv ∈ {-1, 0, +1}`` on the plaquette itself, so δm stays 0.  Swept per
    checkerboard color and 2-form component: same-color plaquettes of one
    component share no links.  Not ergodic alone (cannot change the wrapping)."""

    name = 'PlaquetteUpdate'
    fields = ('m', 'v')

    def __init__(self, action):
        require_worldline(action)
        self.Action = action
        self.Lattice = action.Lattice

    def begin(self, generator, cfg):
        m, v = cfg['m'], cfg['v']
        return {'m': m, 'v': v, 'f': residual(m, v, self.Action.W)}

    def pass_keys(self):
        # one pass per (color, component), in that order
        return [(color, comp) for kind, color, comp in passes(self.Lattice) if kind == 'vortex']

    def run_pass(self, generator, state, key):
        S, L = self.Action, self.Lattice
        color, comp = key
        m, v, f = state['m'], state['v'], state['f']
        site = (m.shape[0],) + L.dims
        mask = shard.mask(generator, L, color, m.device)
        cm = 2 * shard.randint(generator, 0, 2, site, device=m.device, dtype=m.dtype) - 1
        cv = shard.randint(generator, -1, 2, site, device=m.device).to(v.dtype)
        t = on_component(torch.where(mask, cm, 0), comp, L)
        change_v = on_component(torch.where(mask, cv, 0), comp, L)
        dS = plaquette_delta_s(S.kappa, L, f, t, change_v, S.W, comp)
        accept, prob = metropolis(shard.rand(generator, site, dtype=f.dtype, device=m.device), dS)
        accept = accept & mask
        applied_t = on_component(torch.where(accept, cm, 0), comp, L)
        applied_v = on_component(torch.where(accept, cv, 0), comp, L)
        dm = calc.delta(L, 2, applied_t)
        f = f + dm.to(f.dtype) - calc.delta(L, 2, applied_v).to(f.dtype) * inverse_w(S.W)
        state = {'m': m + dm, 'v': v + applied_v, 'f': f}
        return (state, shard.site_sum(generator, accept, L.D),
                shard.site_sum(generator, torch.where(mask, prob, 0), L.D))

    def tally(self, stats, chains, accepted, acceptance):
        plaquettes = self.Lattice.cells_of_degree[2]
        return self._tally(stats, chains, accepted, plaquettes, acceptance / plaquettes)


#: The counters of :class:`ClassicWorm`'s calls (:func:`..tracing.count_on_device`).
WORM_COUNTERS = ('worm.worldline.calls', 'worm.worldline.worms', 'worm.worldline.moves',
                 'worm.worldline.longest', 'worm.worldline.truncated')


class ClassicWorm(_WormReport, Generator):
    r"""Prokof'ev–Svistunov worm on the sites, one per chain and step, in any D:
    :func:`..ops.worldline_worm.worldline_worms` in D=2 (B5 on the card), and
    :func:`..ops.worldline_worm.worldline_worms_general` at D >= 3 (K2 on the
    card).  Tallies the inline ``Spin_Spin`` histogram and
    ``Worm_Length``.  ``max_moves`` caps a worm; an unclosed worm breaks δm = 0
    and is rolled back at every W.  Never changes v.

    While a profiler records, each step counts, on the fields' device and
    without waiting for it (:data:`WORM_COUNTERS`): one call, its chains'
    worms, their summed and their longest length in moves, and the worms
    truncated."""

    name = 'ClassicWorm'
    fields = ('m', 'v')

    def __init__(self, action, max_moves=None):
        require_worldline(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.max_moves = None if max_moves is None else int(max_moves)

    def inline_shapes(self):
        return {'Spin_Spin': self.Lattice.dims, 'Worm_Length': ()}

    def step(self, generator, cfg, stats):
        m, v, L = cfg['m'], cfg['v'], self.Lattice
        worms = worldline_worms if L.D == 2 else worldline_worms_general
        m, hist, length, truncated = worms(
            m, v, kappa=self.Action.kappa, W=self.Action.W, worms=1,
            max_worm_moves=self.max_moves, generator=generator)
        stats = self._tally(stats, m.shape[0], length, length, 1 - truncated)
        if recording():
            moves = length.to(torch.int64)
            one = torch.ones_like(moves[0])
            count_on_device(WORM_COUNTERS, torch.stack((
                one, one * len(moves), moves.sum(), moves.max(),
                truncated.to(torch.int64).sum())))
        # Float32 tallies, as the JAX package keeps them (exact below 2**24).
        return cfg | {'m': m}, stats, {'Spin_Spin': hist.float(), 'Worm_Length': length.float()}


#: The fleet's worm cap at D >= 3, in moves a site.  In D=2 the cap is 8 a
#: site, as the JAX package caps it; at D >= 3 a worm covers more sites
#: before it closes.  At D=4, N=8, κ=0.3, W=1 (8192 chains, 20 records of 2
#: steps from the cold start, three seeds on an H100) 8, 16 and 32 a site
#: truncated 13.5%, 4.4% and 0.45% of the worms, and 64 a site, the least of
#: 8·2^k within :data:`..parallel.fleet.TRUNCATION_BUDGET`, 0.004%.
FLEET_CAP_PER_SITE = 64


def fleet_worm_cap(lattice):
    """The worm cap of ``Hammer(S, fleet=True)`` on ``lattice``: 8 moves a
    site in D=2, :data:`FLEET_CAP_PER_SITE` at D >= 3."""
    return (8 if lattice.D == 2 else FLEET_CAP_PER_SITE) * lattice.sites


def Hammer(S, worms=1, fleet=False, max_worm_moves=None):
    """Ergodic composite for the Worldline action:
    Sequentially(Vortex, Coexact, Wrapping, Worm).

    ``fleet``: bound the worm's step time over many chains
    (``max_moves=max_worm_moves``, default :func:`fleet_worm_cap`: 8·sites in
    D=2, 64·sites at D >= 3); ``max_worm_moves`` also caps the worm without
    ``fleet``.  Any D; at D >= 3 the worm is K2 on the card and the
    other updates PyTorch operations."""
    require_worldline(S)
    cap = max_worm_moves
    if fleet and cap is None:
        cap = fleet_worm_cap(S.Lattice)
    worm = ClassicWorm(S, max_moves=cap)
    return Sequentially((VortexUpdate(S), CoexactUpdate(S), WrappingUpdate(S),
                         KeepEvery(worms, worm) if worms > 1 else worm))
