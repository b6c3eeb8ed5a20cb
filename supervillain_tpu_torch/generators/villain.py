"""Monte-Carlo updates for the Villain action (D=2), over the plain versions.

PyTorch counterparts of ``NeighborhoodUpdate``, ``ExactNeighborhoodUpdate`` and
``ClassicWorm`` of :mod:`supervillain_tpu.generators.villain`.  Each step runs
the plain PyTorch version of :mod:`..ops.sweep` or :mod:`..ops.worm` on one
chain, on whatever device its fields are, with draws from the step's
``torch.Generator``; the algebra lives only there.
"""

from __future__ import annotations

import numpy as np

from ..models import Villain
from ..ops.sweep import SweepDraws, plain_sweeps
from ..ops.worm import WormDraws, plain_worms
from .base import Generator


def require_villain_2d(action):
    if not isinstance(action, Villain):
        raise ValueError('Need a Villain action')
    if action.Lattice.D != 2:
        raise NotImplementedError('The port implements the Villain updates for D=2')


class NeighborhoodUpdate(Generator):
    r"""Simultaneous site-neighborhood update: Δφ at each same-color site plus
    ``Δn ∈ W·{-interval_n..interval_n}`` on the links touching it (zero-inflated
    with probability ``p_n`` of a nonzero Δn when given).

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
        phi, n = cfg['phi'][None], cfg['n'][None]
        W = self._kernel_W()
        draws = SweepDraws(generator, B=1, N=L.N, interval_phi=self.interval_phi,
                           interval_n=self.interval_n, p_n=self.p_n,
                           zmode=W == float('inf'), fdt=phi.dtype, idt=n.dtype,
                           device=phi.device)
        phi, n, accepted, _ = plain_sweeps(phi, n, kappa=self.Action.kappa, W=W,
                                           sweeps=1, draws=draws)
        accepted = float(accepted[0])
        stats = self._tally(stats, accepted, L.sites, accepted / L.sites)
        return cfg | {'phi': phi[0], 'n': n[0]}, stats, {}


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


class ClassicWorm(Generator):
    r"""Prokof'ev–Svistunov worm on the plaquettes: tallies the inline
    ``Vortex_Vortex`` histogram and ``Worm_Length``.  ``max_moves`` caps a worm;
    an unclosed worm is rolled back at W≠1 and kept at W=1.  Not ergodic alone
    (never changes φ or dn)."""

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
        phi, n = cfg['phi'][None], cfg['n'][None]
        draws = WormDraws(generator, B=1, N=self.Lattice.N, fdt=phi.dtype, device=phi.device)
        n, hist, length, truncated = plain_worms(
            phi, n, kappa=self.Action.kappa, W=self.Action.W, worms=1,
            max_worm_moves=self.max_moves, draws=draws)
        wl = float(length[0])
        stats = self._tally(stats, wl, wl, 1.0 - float(truncated[0]))
        return cfg | {'n': n[0]}, stats, {'Vortex_Vortex': hist[0], 'Worm_Length': length[0]}

    def report(self, stats):
        s = stats[self.name]
        worms = max(s['sweeps'], 1.0)
        line = f'{self.name}: {worms:.0f} worms, mean length {s["accepted"] / worms:.3f}'
        truncated = worms - s['acceptance']
        if self.max_moves is not None and truncated > 0.5:
            line += f' ({truncated:.0f} truncated at max_moves={self.max_moves})'
        return line
