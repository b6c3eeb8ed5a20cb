"""Monte-Carlo updates for the Worldline action (D=2), over the plain versions.

PyTorch counterparts of ``VortexUpdate``, ``CoexactUpdate``, ``WrappingUpdate``
and ``ClassicWorm`` of :mod:`supervillain_tpu.generators.worldline`.  Each step
runs the passes of :mod:`..ops.worldline` or the worm of
:mod:`..ops.worldline_worm` on one chain, on whatever device its fields are,
with draws from the step's ``torch.Generator``; the algebra lives only there.
"""

from __future__ import annotations

from ..models import Worldline
from ..ops.worldline import (WorldlineSweepDraws, coexact_pass, residual, vortex_pass,
                             wrapping_pass)
from ..ops.worldline_worm import WorldlineWormDraws, plain_worldline_worms
from ..device import float_dtype_of
from .base import Generator


def require_worldline_2d(action):
    if not isinstance(action, Worldline):
        raise ValueError('Need a Worldline action')
    if action.Lattice.D != 2:
        raise NotImplementedError('The port implements the Worldline updates for D=2')


class _LocalUpdate(Generator):
    """A checkerboarded local update of one chain: ``_passes`` runs its passes
    on the batch of one and returns the fields and the accepted count."""

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
        m, v = cfg['m'][None], cfg['v'][None]
        draws = WorldlineSweepDraws(
            generator, B=1, N=self.Lattice.N, interval_v=self.interval_v,
            interval_t=self.interval_t, interval_w=self.interval_w,
            winf=self.Action.W == float('inf'), fdt=float_dtype_of(v), idt=m.dtype,
            device=m.device)
        m, v, accepted = self._passes(m, v, residual(m, v, self.Action.W), draws)
        accepted = float(accepted[0])
        proposals = self._proposals()
        stats = self._tally(stats, accepted, proposals, accepted / proposals)
        return cfg | {'m': m[0], 'v': v[0]}, stats, {}


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


class ClassicWorm(Generator):
    r"""Prokof'ev–Svistunov worm on the sites: tallies the inline ``Spin_Spin``
    histogram and ``Worm_Length``.  ``max_moves`` caps a worm; an unclosed worm
    breaks δm = 0 and is rolled back at every W.  Never changes v."""

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
        m, v = cfg['m'][None], cfg['v'][None]
        draws = WorldlineWormDraws(generator, B=1, N=self.Lattice.N, fdt=float_dtype_of(v),
                                   device=m.device)
        m, hist, length, truncated = plain_worldline_worms(
            m, v, kappa=self.Action.kappa, W=self.Action.W, worms=1,
            max_worm_moves=self.max_moves, draws=draws)
        wl = float(length[0])
        stats = self._tally(stats, wl, wl, 1.0 - float(truncated[0]))
        return cfg | {'m': m[0]}, stats, {'Spin_Spin': hist[0], 'Worm_Length': length[0]}

    def report(self, stats):
        s = stats[self.name]
        worms = max(s['sweeps'], 1.0)
        line = f'{self.name}: {worms:.0f} worms, mean length {s["accepted"] / worms:.3f}'
        truncated = worms - s['acceptance']
        if self.max_moves is not None and truncated > 0.5:
            line += f' ({truncated:.0f} truncated at max_moves={self.max_moves})'
        return line
