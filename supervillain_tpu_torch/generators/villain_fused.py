"""Fused Villain generators: many sweeps (and worms) per call, on the kernels.

PyTorch counterparts of :mod:`supervillain_tpu.generators.villain_fused`.  Each
step calls a wrapper of :mod:`..ops`, which runs the CUDA kernels for fields on
a GPU and the plain versions for fields on the CPU; the TPU package's size and
backend conditions for falling back to the XLA generators have no counterpart
here.  The inline ``ActionDensity`` and ``WindingSquared`` are averaged over
the step's sweeps.
"""

from __future__ import annotations

import numpy as np

from ..ops.hammer import hammer_sweeps
from ..ops.sweep import neighborhood_sweeps
from ..ops.worm import classic_worms
from .base import Generator, empty_stats
from .villain import require_villain_2d


class FusedNeighborhoodUpdate(Generator):
    """``sweeps_per_step`` neighborhood sweeps per step in one kernel call."""

    name = 'NeighborhoodUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_phi=np.pi, interval_n=1, sweeps_per_step=1, p_n=None):
        require_villain_2d(action)
        if action.W == float('inf'):
            raise ValueError('NeighborhoodUpdate offers Δn in multiples of W; undefined at '
                             'W=inf — use FusedExactNeighborhoodUpdate.')
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_phi = float(interval_phi)
        self.interval_n = int(interval_n)
        self.sweeps_per_step = int(sweeps_per_step)
        self.p_n = None if p_n is None else float(p_n)
        self._kernel_W = action.W

    def inline_shapes(self):
        return {'ActionDensity': (), 'WindingSquared': ()}

    def step(self, generator, cfg, stats):
        S, L = self.Action, self.Lattice
        phi, n, accepted, inline = neighborhood_sweeps(
            cfg['phi'][None], cfg['n'][None], kappa=S.kappa, W=self._kernel_W,
            interval_phi=self.interval_phi, interval_n=self.interval_n,
            sweeps=self.sweeps_per_step, p_n=self.p_n, generator=generator)
        su = L.sites * self.sweeps_per_step
        accepted = float(accepted[0])
        stats = self._tally(stats, accepted, su, accepted / su, sweeps=self.sweeps_per_step)
        return (cfg | {'phi': phi[0], 'n': n[0]}, stats,
                {k: v[0] for k, v in inline.items()})


class FusedExactNeighborhoodUpdate(FusedNeighborhoodUpdate):
    """Fused compound (Δφ, Δz) sweeps in z-mode: the W=∞ fused path."""

    name = 'ExactNeighborhoodUpdate'

    def __init__(self, action, interval_phi=np.pi, interval_z=1, sweeps_per_step=1, p_z=None):
        require_villain_2d(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_phi = float(interval_phi)
        self.interval_n = int(interval_z)
        self.sweeps_per_step = int(sweeps_per_step)
        self.p_n = None if p_z is None else float(p_z)
        self._kernel_W = float('inf')


class FusedHammer(Generator):
    """``sweeps_per_step`` neighborhood sweeps then ``worms`` classic worms per
    step (:func:`..ops.hammer.hammer_sweeps`).  ``W = ∞`` runs the sweeps in
    z-mode with the worms kept.  Inline ``ActionDensity``/``WindingSquared``
    and the worm's ``Vortex_Vortex``/``Worm_Length``/``Worm_Truncated``."""

    name = 'FusedHammer'
    fields = ('phi', 'n')

    def __init__(self, action, interval_phi=np.pi, interval_n=1, sweeps_per_step=1,
                 worms=1, p_n=None, max_worm_moves=None):
        require_villain_2d(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_phi = float(interval_phi)
        self.interval_n = int(interval_n)
        self.sweeps_per_step = int(sweeps_per_step)
        self.worms = int(worms)
        self.p_n = None if p_n is None else float(p_n)
        self.max_worm_moves = None if max_worm_moves is None else int(max_worm_moves)

    @property
    def _sweep_tag(self):
        return ('ExactNeighborhoodUpdate' if self.Action.W == float('inf')
                else 'NeighborhoodUpdate')

    def init_stats(self):
        return {self._sweep_tag: empty_stats(), 'ClassicWorm': empty_stats()}

    def inline_shapes(self):
        return {'ActionDensity': (), 'WindingSquared': (), 'Vortex_Vortex': self.Lattice.dims,
                'Worm_Length': (), 'Worm_Truncated': ()}

    def step(self, generator, cfg, stats):
        S, L = self.Action, self.Lattice
        phi, n, accepted, inline = hammer_sweeps(
            cfg['phi'][None], cfg['n'][None], kappa=S.kappa, W=S.W,
            interval_phi=self.interval_phi, interval_n=self.interval_n,
            sweeps=self.sweeps_per_step, worms=self.worms, p_n=self.p_n,
            max_worm_moves=self.max_worm_moves, generator=generator)
        accepted = float(accepted[0])
        wl = float(inline['Worm_Length'][0])
        su = L.sites * self.sweeps_per_step
        stats = self._tally(stats, accepted, su, accepted / su, self.sweeps_per_step,
                            tag=self._sweep_tag)
        stats = self._tally(stats, wl, wl, 1.0, self.worms, tag='ClassicWorm')
        return (cfg | {'phi': phi[0], 'n': n[0]}, stats,
                {k: v[0] for k, v in inline.items()})


class FusedClassicWorm(Generator):
    """``worms`` classic worms per step in one kernel call."""

    name = 'ClassicWorm'
    fields = ('phi', 'n')

    def __init__(self, action, worms=1, max_worm_moves=None):
        require_villain_2d(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.worms = int(worms)
        self.max_worm_moves = None if max_worm_moves is None else int(max_worm_moves)

    def inline_shapes(self):
        return {'Vortex_Vortex': self.Lattice.dims, 'Worm_Length': ()}

    def step(self, generator, cfg, stats):
        S = self.Action
        n, hist, length, _ = classic_worms(
            cfg['phi'][None], cfg['n'][None], kappa=S.kappa, W=S.W, worms=self.worms,
            max_worm_moves=self.max_worm_moves, generator=generator)
        wl = float(length[0])
        stats = self._tally(stats, wl, wl, 1.0, sweeps=self.worms)
        return cfg | {'n': n[0]}, stats, {'Vortex_Vortex': hist[0], 'Worm_Length': length[0]}
