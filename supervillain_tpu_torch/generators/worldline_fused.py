"""Fused Worldline generators: many sweeps (and worms) per call, on the kernels.

PyTorch counterparts of :mod:`supervillain_tpu.generators.worldline_fused`.
Each step calls a wrapper of :mod:`..ops`, which runs the CUDA kernels for
fields on a GPU and the plain versions for fields on the CPU; the TPU
package's backend and ``N % 128`` conditions for falling back to the XLA
generators have no counterpart here.  The stats tags and proposal counts are
the TPU kernels': ``WorldlineLocalUpdates`` (2·sites + 2N proposals per sweep)
and ``ClassicWorm``.
"""

from __future__ import annotations

from ..ops.worldline import worldline_sweeps
from ..ops.worldline_hammer import worldline_hammer_sweeps
from ..ops.worldline_worm import worldline_worms
from .base import Generator, empty_stats
from .worldline import require_worldline_2d


class FusedWorldlineUpdate(Generator):
    """``sweeps_per_step`` worldline local-update sweeps (vortex, coexact and
    wrapping passes) per step in one kernel call.  No inline observables."""

    name = 'WorldlineLocalUpdates'
    fields = ('m', 'v')

    def __init__(self, action, interval_v=1, interval_t=1, interval_w=1, sweeps_per_step=1):
        require_worldline_2d(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.interval_v = float(interval_v) if action.W == float('inf') else int(interval_v)
        self.interval_t = int(interval_t)
        self.interval_w = int(interval_w)
        self.sweeps_per_step = int(sweeps_per_step)

    def _proposals(self):
        L = self.Lattice
        return (2 * L.sites + 2 * L.N) * self.sweeps_per_step

    def _sweep_args(self):
        return dict(kappa=self.Action.kappa, W=self.Action.W, interval_v=self.interval_v,
                    interval_t=self.interval_t, interval_w=self.interval_w,
                    sweeps=self.sweeps_per_step)

    def step(self, generator, cfg, stats):
        m, v, accepted, _ = worldline_sweeps(cfg['m'], cfg['v'], generator=generator,
                                             **self._sweep_args())
        stats = self._tally(stats, m.shape[0], accepted, self._proposals(),
                            accepted / self._proposals(), sweeps=self.sweeps_per_step)
        return cfg | {'m': m, 'v': v}, stats, {}


class FusedWorldlineWorm(Generator):
    """``worms`` worldline worms per step in one kernel call."""

    name = 'ClassicWorm'
    fields = ('m', 'v')

    def __init__(self, action, worms=1, max_worm_moves=None):
        require_worldline_2d(action)
        self.Action = action
        self.Lattice = action.Lattice
        self.worms = int(worms)
        self.max_worm_moves = None if max_worm_moves is None else int(max_worm_moves)

    def inline_shapes(self):
        return {'Spin_Spin': self.Lattice.dims, 'Worm_Length': ()}

    def step(self, generator, cfg, stats):
        S = self.Action
        m, hist, length, _ = worldline_worms(
            cfg['m'], cfg['v'], kappa=S.kappa, W=S.W, worms=self.worms,
            max_worm_moves=self.max_worm_moves, generator=generator)
        stats = self._tally(stats, m.shape[0], length, length, 1.0, sweeps=self.worms)
        return cfg | {'m': m}, stats, {'Spin_Spin': hist, 'Worm_Length': length}


class FusedWorldlineHammer(FusedWorldlineUpdate):
    """``sweeps_per_step`` worldline local-update sweeps then ``worms`` worms
    per step (:func:`..ops.worldline_hammer.worldline_hammer_sweeps`), at any W
    including ∞.  Inline ``ActionDensity`` is the kernels' (1/2κ)Σ(m − δv/_W)²/Λ
    averaged over the sweeps (1 minus the registry observable of that name in
    D=2), beside the worm's ``Spin_Spin``/``Worm_Length``/``Worm_Truncated``."""

    name = 'FusedWorldlineHammer'

    def __init__(self, action, interval_v=1, interval_t=1, interval_w=1, sweeps_per_step=1,
                 worms=1, max_worm_moves=None):
        super().__init__(action, interval_v, interval_t, interval_w, sweeps_per_step)
        self.worms = int(worms)
        self.max_worm_moves = None if max_worm_moves is None else int(max_worm_moves)

    def init_stats(self):
        return {'WorldlineLocalUpdates': empty_stats(), 'ClassicWorm': empty_stats()}

    def inline_shapes(self):
        return {'ActionDensity': (), 'Spin_Spin': self.Lattice.dims, 'Worm_Length': (),
                'Worm_Truncated': ()}

    def step(self, generator, cfg, stats):
        m, v, accepted, inline = worldline_hammer_sweeps(
            cfg['m'], cfg['v'], worms=self.worms,
            max_worm_moves=self.max_worm_moves, generator=generator, **self._sweep_args())
        B, wl = m.shape[0], inline['Worm_Length']
        proposals = self._proposals()
        stats = self._tally(stats, B, accepted, proposals, accepted / proposals,
                            self.sweeps_per_step, tag='WorldlineLocalUpdates')
        stats = self._tally(stats, B, wl, wl, 1.0, self.worms, tag='ClassicWorm')
        return cfg | {'m': m, 'v': v}, stats, inline
