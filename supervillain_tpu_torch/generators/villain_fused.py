"""Fused Villain generators: many sweeps (and worms) per call, on the kernels.

PyTorch counterparts of :mod:`supervillain_tpu.generators.villain_fused`.  Each
step calls a wrapper of :mod:`..ops`, which runs the CUDA kernels for fields on
a GPU and the plain versions for fields on the CPU; the TPU package's size and
backend conditions for falling back to the XLA generators have no counterpart
here.  The inline ``ActionDensity`` and ``WindingSquared`` are averaged over
the step's sweeps.

The kernels are D=2 only, as the TPU kernels are.  At D >= 3 the fused sweeps
run the eager :class:`~.villain.NeighborhoodUpdate` (or
``ExactNeighborhoodUpdate``) ``sweeps_per_step`` times, as PyTorch operations
with no inline columns, as the JAX package falls back to its XLA updates; the
fused worms and ``FusedHammer`` raise there, as the JAX worm does.
"""

from __future__ import annotations

import numpy as np

from ..ops.hammer import hammer_sweeps
from ..ops.sweep import neighborhood_sweeps
from ..ops.worm import classic_worms
from .base import Generator, empty_stats
from .villain import (ExactNeighborhoodUpdate, NeighborhoodUpdate, require_villain,
                      require_worm_2d)


class FusedNeighborhoodUpdate(Generator):
    """``sweeps_per_step`` neighborhood sweeps per step in one kernel call."""

    name = 'NeighborhoodUpdate'
    fields = ('phi', 'n')

    def __init__(self, action, interval_phi=np.pi, interval_n=1, sweeps_per_step=1, p_n=None):
        require_villain(action)
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
        self._fallback = self._eager() if action.Lattice.D != 2 else None

    def _eager(self):
        return NeighborhoodUpdate(self.Action, self.interval_phi, self.interval_n, p_n=self.p_n)

    def inline_shapes(self):
        if self._fallback is not None:
            return {}
        return {'ActionDensity': (), 'WindingSquared': ()}

    def step(self, generator, cfg, stats):
        if self._fallback is not None:
            for _ in range(self.sweeps_per_step):
                cfg, stats, _ = self._fallback.step(generator, cfg, stats)
            return cfg, stats, {}
        S, L = self.Action, self.Lattice
        phi, n, accepted, inline = neighborhood_sweeps(
            cfg['phi'], cfg['n'], kappa=S.kappa, W=self._kernel_W,
            interval_phi=self.interval_phi, interval_n=self.interval_n,
            sweeps=self.sweeps_per_step, p_n=self.p_n, generator=generator)
        su = L.sites * self.sweeps_per_step
        stats = self._tally(stats, phi.shape[0], accepted, su, accepted / su,
                            sweeps=self.sweeps_per_step)
        return cfg | {'phi': phi, 'n': n}, stats, inline


class FusedExactNeighborhoodUpdate(FusedNeighborhoodUpdate):
    """Fused compound (Δφ, Δz) sweeps in z-mode: the W=∞ fused path."""

    name = 'ExactNeighborhoodUpdate'

    def __init__(self, action, interval_phi=np.pi, interval_z=1, sweeps_per_step=1, p_z=None):
        require_villain(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_phi = float(interval_phi)
        self.interval_n = int(interval_z)
        self.sweeps_per_step = int(sweeps_per_step)
        self.p_n = None if p_z is None else float(p_z)
        self._kernel_W = float('inf')
        self._fallback = self._eager() if action.Lattice.D != 2 else None

    def _eager(self):
        return ExactNeighborhoodUpdate(self.Action, self.interval_phi, self.interval_n,
                                       p_z=self.p_n)

    # The JAX package's names of the Δz interval and zero-inflation.
    interval_z = property(lambda self: self.interval_n)
    p_z = property(lambda self: self.p_n)


class FusedHammer(Generator):
    """``sweeps_per_step`` neighborhood sweeps then ``worms`` classic worms per
    step (:func:`..ops.hammer.hammer_sweeps`).  ``W = ∞`` runs the sweeps in
    z-mode with the worms kept.  Inline ``ActionDensity``/``WindingSquared``
    and the worm's ``Vortex_Vortex``/``Worm_Length``/``Worm_Truncated``."""

    name = 'FusedHammer'
    fields = ('phi', 'n')

    def __init__(self, action, interval_phi=np.pi, interval_n=1, sweeps_per_step=1,
                 worms=1, p_n=None, max_worm_moves=None):
        require_worm_2d(action, 'FusedHammer')
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
            cfg['phi'], cfg['n'], kappa=S.kappa, W=S.W,
            interval_phi=self.interval_phi, interval_n=self.interval_n,
            sweeps=self.sweeps_per_step, worms=self.worms, p_n=self.p_n,
            max_worm_moves=self.max_worm_moves, generator=generator)
        B, wl = phi.shape[0], inline['Worm_Length']
        su = L.sites * self.sweeps_per_step
        stats = self._tally(stats, B, accepted, su, accepted / su, self.sweeps_per_step,
                            tag=self._sweep_tag)
        stats = self._tally(stats, B, wl, wl, 1.0, self.worms, tag='ClassicWorm')
        return cfg | {'phi': phi, 'n': n}, stats, inline


class FusedClassicWorm(Generator):
    """``worms`` classic worms per step in one kernel call."""

    name = 'ClassicWorm'
    fields = ('phi', 'n')

    def __init__(self, action, worms=1, max_worm_moves=None):
        require_worm_2d(action, 'ClassicWorm')
        self.Action = action
        self.Lattice = action.Lattice
        self.worms = int(worms)
        self.max_worm_moves = None if max_worm_moves is None else int(max_worm_moves)

    def inline_shapes(self):
        return {'Vortex_Vortex': self.Lattice.dims, 'Worm_Length': ()}

    def step(self, generator, cfg, stats):
        S = self.Action
        n, hist, length, _ = classic_worms(
            cfg['phi'], cfg['n'], kappa=S.kappa, W=S.W, worms=self.worms,
            max_worm_moves=self.max_worm_moves, generator=generator)
        stats = self._tally(stats, n.shape[0], length, length, 1.0, sweeps=self.worms)
        return cfg | {'n': n}, stats, {'Vortex_Vortex': hist, 'Worm_Length': length}
