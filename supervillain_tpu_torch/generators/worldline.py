"""Monte-Carlo updates for the Worldline action (D=2), on a batch of chains.

PyTorch counterparts of the updates of :mod:`supervillain_tpu.generators.worldline`
and of its ``Hammer``.  Every step takes fields with a leading chain axis.
``VortexUpdate``, ``CoexactUpdate`` and ``WrappingUpdate`` run the passes of
:mod:`..ops.worldline` and ``PlaquetteUpdate`` its own, as PyTorch operations
on either device with draws from the step's ``torch.Generator`` (the JAX
package runs them outside Pallas; the kernel B4 fuses the first three, so none
is a kernel's function alone).  ``ClassicWorm`` runs one worm per chain through
:func:`..ops.worldline_worm.worldline_worms`: the CUDA kernel B5 on the card,
its plain twin on the CPU.
"""

from __future__ import annotations

import torch

from ..models import Worldline
from ..ops import calculus as calc
from ..ops.sweep import lattice
from ..ops.worldline import (WorldlineSweepDraws, coexact_pass, inverse_w, residual,
                             vortex_pass, wrapping_pass)
from ..ops.worldline_worm import worldline_worms
from ..device import float_dtype_of
from .base import Generator, metropolis
from .combining import KeepEvery, Sequentially
from .villain import _WormReport


def require_worldline_2d(action):
    if not isinstance(action, Worldline):
        raise ValueError('Need a Worldline action')
    if action.Lattice.D != 2:
        raise NotImplementedError('The port implements the Worldline updates for D=2')


class _LocalUpdate(Generator):
    """A checkerboarded local update of a batch of chains: ``_passes`` runs its
    passes and returns the fields and the accepted count per chain."""

    fields = ('m', 'v')

    def __init__(self, action, interval_v=1, interval_t=1, interval_w=1):
        require_worldline_2d(action)
        self.Action = action
        self.Lattice = action.Lattice
        # At W=∞ the vortex proposal is continuous U(-interval_v, +interval_v).
        self.interval_v = float(interval_v) if action.W == float('inf') else int(interval_v)
        self.interval_t = int(interval_t)
        self.interval_w = int(interval_w)

    def _proposals(self):
        return self.Lattice.sites

    def step(self, generator, cfg, stats):
        m, v = cfg['m'], cfg['v']
        draws = WorldlineSweepDraws(
            generator, B=m.shape[0], N=self.Lattice.N, interval_v=self.interval_v,
            interval_t=self.interval_t, interval_w=self.interval_w,
            winf=self.Action.W == float('inf'), fdt=float_dtype_of(v), idt=m.dtype,
            device=m.device)
        m, v, accepted = self._passes(m, v, residual(m, v, self.Action.W), draws)
        proposals = self._proposals()
        accepted = accepted.to(draws.fdt)
        stats = self._tally(stats, m.shape[0], accepted, proposals, accepted / proposals)
        return cfg | {'m': m, 'v': v}, stats, {}


class VortexUpdate(_LocalUpdate):
    r"""Metropolis update of v alone, per checkerboard color: ``Δv ∈
    ±{1..interval_v}`` (finite W) or ``U(-interval_v, +interval_v)`` (W=∞).
    The stats' ``acceptance`` tallies the realized accepted fraction."""

    name = 'VortexUpdate'

    def __init__(self, action, interval_v=1):
        super().__init__(action, interval_v=interval_v)

    def _passes(self, m, v, u, draws):
        accepted = 0
        for color in range(2):
            v, u, acc = vortex_pass(v, u, color, draws('vortex', color),
                                    kappa=self.Action.kappa, W=self.Action.W)
            accepted = accepted + acc
        return m, v, accepted


class CoexactUpdate(_LocalUpdate):
    r"""Coordinated update ``Δm = δt`` with t an integer 2-form on one color, so
    ``δ(Δm) = δ²t = 0`` and the constraint survives."""

    name = 'CoexactUpdate'

    def __init__(self, action, interval_t=1):
        super().__init__(action, interval_t=interval_t)

    def _passes(self, m, v, u, draws):
        accepted = 0
        for color in range(2):
            m, u, acc = coexact_pass(m, u, color, draws('coexact', color), kappa=self.Action.kappa)
            accepted = accepted + acc
        return m, v, accepted


class WrappingUpdate(_LocalUpdate):
    r"""Coordinated ``Δm ∈ ±{1..interval_w}`` on entire straight cycles around
    the torus, one proposal per direction μ and perpendicular position: the only
    local update that changes the wrapping."""

    name = 'WrappingUpdate'

    def __init__(self, action, interval_w=1):
        super().__init__(action, interval_w=interval_w)

    def _proposals(self):
        return 2 * self.Lattice.N

    def _passes(self, m, v, u, draws):
        m, u, accepted = wrapping_pass(m, u, draws('wrapping', 0), draws('wrapping', 1),
                                       kappa=self.Action.kappa)
        return m, v, accepted


def plaquette_delta_s(kappa, L, f, t, change_v, W):
    """ΔS at each plaquette of a PlaquetteUpdate proposal on one color: the
    boundary change δt and Δv (each (B, 1, N, N)) change the links' residual
    f = m − δv/_W by δt − δΔv/_W."""
    change_f = calc.delta(L, 2, t).to(f.dtype) - calc.delta(L, 2, change_v).to(f.dtype) * inverse_w(W)
    return calc.coface_sum(L, 1, (0.5 / kappa) * change_f * (2 * f + change_f))[:, 0]


class PlaquetteUpdate(Generator):
    r"""Coordinated ±1 on the 4 boundary links of each plaquette (Δm = δt) together
    with ``Δv ∈ {-1, 0, +1}`` on the plaquette itself, so δm stays 0.  Swept per
    checkerboard color: same-color plaquettes share no links.  Not ergodic alone
    (cannot change the wrapping)."""

    name = 'PlaquetteUpdate'
    fields = ('m', 'v')

    def __init__(self, action):
        require_worldline_2d(action)
        self.Action = action
        self.Lattice = action.Lattice

    def step(self, generator, cfg, stats):
        S = self.Action
        m, v = cfg['m'], cfg['v']
        B, N = m.shape[0], m.shape[-1]
        L = lattice(N)
        f = residual(m, v, S.W)
        accepted = acceptance = 0
        for color in range(L.n_colors):
            mask = L.mask(color, m.device)
            cm = 2 * torch.randint(0, 2, (B, N, N), generator=generator, device=m.device,
                                   dtype=m.dtype) - 1
            cv = torch.randint(-1, 2, (B, N, N), generator=generator, device=m.device).to(v.dtype)
            t = torch.where(mask, cm, 0)[:, None]
            change_v = torch.where(mask, cv, 0)[:, None]
            dS = plaquette_delta_s(S.kappa, L, f, t, change_v, S.W)
            accept, prob = metropolis(torch.rand((B, N, N), generator=generator, dtype=f.dtype,
                                                 device=m.device), dS)
            accept = accept & mask
            applied_t = torch.where(accept, t[:, 0], 0)[:, None]
            applied_v = torch.where(accept, change_v[:, 0], 0)[:, None]
            dm = calc.delta(L, 2, applied_t)
            m = m + dm
            v = v + applied_v
            f = f + dm.to(f.dtype) - calc.delta(L, 2, applied_v).to(f.dtype) * inverse_w(S.W)
            accepted = accepted + accept.sum(dim=(-2, -1))
            acceptance = acceptance + torch.where(mask, prob, 0).sum(dim=(-2, -1))
        stats = self._tally(stats, B, accepted, L.sites, acceptance / L.sites)
        return cfg | {'m': m, 'v': v}, stats, {}


class ClassicWorm(_WormReport, Generator):
    r"""Prokof'ev–Svistunov worm on the sites, one per chain and step:
    :func:`..ops.worldline_worm.worldline_worms` (B5 on the card).  Tallies the
    inline ``Spin_Spin`` histogram and ``Worm_Length``.  ``max_moves`` caps a
    worm; an unclosed worm breaks δm = 0 and is rolled back at every W.  Never
    changes v."""

    name = 'ClassicWorm'
    fields = ('m', 'v')

    def __init__(self, action, max_moves=None):
        require_worldline_2d(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.max_moves = None if max_moves is None else int(max_moves)

    def inline_shapes(self):
        return {'Spin_Spin': self.Lattice.dims, 'Worm_Length': ()}

    def step(self, generator, cfg, stats):
        m = cfg['m']
        m, hist, length, truncated = worldline_worms(
            m, cfg['v'], kappa=self.Action.kappa, W=self.Action.W, worms=1,
            max_worm_moves=self.max_moves, generator=generator)
        stats = self._tally(stats, m.shape[0], length, length, 1 - truncated)
        # Float32 tallies, as the JAX package keeps them (exact below 2**24).
        return cfg | {'m': m}, stats, {'Spin_Spin': hist.float(), 'Worm_Length': length.float()}


def Hammer(S, worms=1, fleet=False, max_worm_moves=None):
    """Ergodic composite for the Worldline action:
    Sequentially(Vortex, Coexact, Wrapping, Worm).

    ``fleet``: bound the worm's step time over many chains
    (``max_moves=max_worm_moves``, default 8·sites); ``max_worm_moves`` also
    caps the worm without ``fleet``."""
    require_worldline_2d(S)
    cap = max_worm_moves
    if fleet and cap is None:
        cap = 8 * S.Lattice.sites
    worm = ClassicWorm(S, max_moves=cap)
    return Sequentially((VortexUpdate(S), CoexactUpdate(S), WrappingUpdate(S),
                         KeepEvery(worms, worm) if worms > 1 else worm))
