"""Fleets of independent Markov chains.

PyTorch counterpart of :mod:`supervillain_tpu.parallel.fleet`: :class:`Fleet`,
the draws of many chains as NumPy columns of shape (kept, chains, ...), with
views as ensembles; and :func:`sample_fleet`, which runs any generator over a
batch of chains.  Where the JAX package ``vmap``s a generator over chains, the
port hands every step the whole batch as a leading axis of the fields.
Sharding chains over devices (the JAX ``mesh``) is not ported.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..configurations import Configurations
from ..device import resolve_device, to_device
from ..ensemble import Ensemble
from ..generators import KeepEvery
from ..generators.base import host_stats

logger = logging.getLogger(__name__)


class Fleet:
    """Draws from many independent chains: columns of shape (kept, chains, ...),
    per-chain final configurations, pooled statistics."""

    def __init__(self, action, columns, stats, final, index, weight=None, device='cuda'):
        self.Action = action
        self.device = device            # where the chains ran; their ensembles measure there
        self.columns = columns          # name -> np.ndarray (kept, chains, ...)
        self.stats = stats              # aggregated over chains
        self.final = final              # name -> np.ndarray (chains, ...)
        self.index = index
        self.weight = weight if weight is not None else np.ones(len(index))

    @property
    def chains(self):
        return next(iter(self.columns.values())).shape[1]

    def __len__(self):
        return len(self.index)

    def ensemble(self, chain):
        """View chain ``chain`` as an :class:`Ensemble`."""
        e = Ensemble(self.Action).from_configurations(
            Configurations({k: v[:, chain] for k, v in self.columns.items()}), device=self.device)
        e.index = self.index
        e.index_stride = int(self.index[1] - self.index[0]) if len(self.index) > 1 else 1
        e.weight = self.weight
        return e

    def pooled_ensemble(self, cut=0):
        """Concatenate all chains (after a per-chain thermalization ``cut``) into one
        ensemble of independent-by-construction draws."""
        cols = {k: v[cut:].reshape((-1,) + v.shape[2:]) for k, v in self.columns.items()}
        e = Ensemble(self.Action).from_configurations(Configurations(cols), device=self.device)
        e.index = np.arange(len(next(iter(cols.values()))))
        e.index_stride = 1
        e.weight = np.ones(len(e.index))
        return e

    def to_h5(self, group):
        from ..io import fleet_to_h5
        fleet_to_h5(self, group)

    @classmethod
    def from_h5(cls, group, device='cuda'):
        from ..io import fleet_from_h5
        return fleet_from_h5(group, device=device)

    def extend_h5(self, group):
        from ..io import fleet_extend_h5
        fleet_extend_h5(self, group)


# An unbounded ClassicWorm over a fleet makes every step wait for the slowest
# chain's excursion (the max over chains, not the mean), which grows without
# bound near criticality; the floor is deliberately conservative and
# W-independent.
_WORM_BOUND_FLOOR = 8


def _bounded_worms(generator, action, chains, policy):
    """Fleet worm-bounding policy.

    ``policy='raise'`` (default): a bare (unbounded) ClassicWorm in the tree
    with ``chains >= _WORM_BOUND_FLOOR`` is an error, naming what to pass
    instead.  ``policy='auto'``: rebuild the tree with
    ``ClassicWorm(max_moves=8·sites)`` (an exact bounded kernel: truncated
    worms roll back) and warn.  ``policy='off'``: pass through unchanged."""
    from ..generators import KeepEvery, Logger, Sequentially, villain, worldline

    if policy not in ('raise', 'auto', 'off'):
        raise ValueError(f"bound_worms must be 'raise', 'auto', or 'off', "
                         f'got {policy!r}')
    if policy == 'off' or chains < _WORM_BOUND_FLOOR:
        return generator

    cap = 8 * action.Lattice.sites
    changed = []

    def rebuild(g):
        if isinstance(g, Sequentially):
            return Sequentially([rebuild(x) for x in g.generators])
        if isinstance(g, KeepEvery):
            return KeepEvery(g.n, rebuild(g.generator), blocked_inline=g.blocked_inline)
        if isinstance(g, Logger):
            inner = rebuild(g.generator)
            return Logger(inner, channel=g.channel, timer=g.timer) if inner is not g.generator else g
        if isinstance(g, (villain.ClassicWorm, worldline.ClassicWorm)) and g.max_moves is None:
            changed.append(g)
            return type(g)(g.Action, max_moves=cap)
        return g

    rebuilt = rebuild(generator)
    if not changed:
        return generator
    if policy == 'raise':
        raise ValueError(
            f'Unbounded ClassicWorm vmapped over {chains} chains: every fleet '
            f'step would wait for the slowest chain\'s worm (max-over-chains, '
            f'not mean).  Pass Hammer(..., fleet=True) or '
            f'ClassicWorm(max_moves=...) to bound it explicitly, '
            f"sample_fleet(..., bound_worms='auto') to let the fleet "
            f'substitute ClassicWorm(max_moves={cap}) (an exact bounded '
            f"kernel), or bound_worms='off' to run unbounded anyway.")
    logger.warning(
        f'Unbounded ClassicWorm vmapped over {chains} chains: substituting '
        f'ClassicWorm(max_moves={cap}) — an exact bounded kernel (truncated '
        f'worms roll back).  Pass Hammer(..., fleet=True) or '
        f'ClassicWorm(max_moves=...) explicitly to silence this.')
    return rebuilt


def sample_fleet(action, generator, *, chains, steps, thin=1, seed=0, mesh=None, start='cold',
                 keep_fields=True, progress=None, bound_worms='raise', device='cuda'):
    """Sample ``chains`` independent chains for ``steps`` kept records, each
    separated by ``thin`` generator steps, on ``device`` (the card unless
    ``device='cpu'``).

    Returns a :class:`Fleet`: the fields of every record (with
    ``keep_fields``) and the generator's inline observables, each averaged
    over its record's ``thin`` steps; the stats summed over chains; each
    chain's final configuration.  ``seed`` is an int that seeds a
    ``torch.Generator`` on ``device``, or such a generator itself.
    ``start`` is ``'cold'`` or a configuration dict every chain starts from.
    ``progress`` wraps the iteration over records.  ``bound_worms`` governs
    an unbounded ClassicWorm in the tree (see :func:`_bounded_worms`):
    ``'raise'`` (default), ``'auto'`` or ``'off'``.  Sharding over devices
    (``mesh``) is not ported and raises."""
    if mesh is not None:
        raise NotImplementedError('sample_fleet of the port runs on one device: '
                                  'a mesh of devices is not ported')
    device = resolve_device(device)
    generator = _bounded_worms(generator, action, chains, bound_worms)
    rng = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=device).manual_seed(int(seed))
    cfg = action.initial(device) if start == 'cold' else \
        {k: to_device(start[k], device) for k in action.fields}
    cfg = generator.prepare({k: v.expand((chains,) + v.shape).contiguous()
                             for k, v in cfg.items()})
    stats = generator.init_stats()

    # A record's inline values are averaged over its thin steps.
    record_step = KeepEvery(thin, generator)
    columns = None
    iterator = range(steps) if progress is None else progress(range(steps))
    for i in iterator:
        cfg, stats, inline = record_step.step(rng, cfg, stats)
        record = {k: v.cpu().numpy() for k, v in ((cfg if keep_fields else {}) | inline).items()}
        if columns is None:
            columns = {k: np.empty((steps,) + v.shape, dtype=v.dtype) for k, v in record.items()}
        for k, v in record.items():
            columns[k][i] = v

    final = {k: v.cpu().numpy() for k, v in cfg.items()}
    index = thin * (1 + np.arange(steps))
    return Fleet(action, columns, host_stats(stats), final, index, device=device)
