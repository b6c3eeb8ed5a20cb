"""Fleets of independent Markov chains.

PyTorch counterpart of :mod:`supervillain_tpu.parallel.fleet`: :class:`Fleet`,
the draws of many chains as NumPy columns of shape (kept, chains, ...), with
views as ensembles; and :func:`sample_fleet`, which runs any generator over a
batch of chains.  Where the JAX package ``vmap``s a generator over chains, the
port hands every step the whole batch as a leading axis of the fields.  With a
chain mesh (:mod:`.mesh`) the chains are cut into contiguous blocks, one a
shard, each run on its device and process; the result is the unsharded one,
bit for bit.
"""

from __future__ import annotations

import logging
import warnings

import numpy as np
import torch

from ..configurations import Configurations
from ..device import resolve_device, to_device
from ..ensemble import Ensemble
from ..generators import KeepEvery
from ..generators.base import host_stats, per_chain_stats
from ..ops.shard import ShardGenerator
from ..tracing import count, span
from . import distributed
from .mesh import ChainMesh, chain_mesh

logger = logging.getLogger(__name__)


#: Truncated-worm fraction above which inline worm histograms should not be
#: used quantitatively (the short-separation bias scales with this fraction).
TRUNCATION_BUDGET = 1e-3


def check_truncation_budget(truncated, total_worms, *, budget=TRUNCATION_BUDGET, context=''):
    """Warn when the truncated fraction of worms exceeds ``budget``; return it.

    Capped worms roll back exactly (the sampled distribution is unbiased) but
    their histogram tallies are kept, so the inline correlator
    (``Vortex_Vortex``, or ``Spin_Spin`` of the Worldline worms) carries a
    short-separation bias proportional to the truncated fraction.  Both fleet
    drivers check their worms against it after a call."""
    total_worms = max(1, int(total_worms))
    frac = float(truncated) / total_worms
    if frac > budget:
        warnings.warn(
            f'{context}{float(truncated):.0f}/{total_worms} worms truncated '
            f'(fraction {frac:.2e} > {budget:g}) — inline worm histograms '
            f'carry short-separation bias at this point; raise '
            f'max_worm_moves or exclude the inline correlator from fits.',
            stacklevel=2)
    return frac


class Fleet:
    """Draws from many independent chains: columns of shape (kept, chains, ...),
    per-chain final configurations, pooled statistics.  ``mesh`` records where
    the chains ran: the mesh's ``size`` and each shard's device ``kinds``.

    A fleet of :func:`.fused_fleet.sample_fused_fleet` that ran on cards holds
    its columns and final fields as NumPy views of page-locked host memory,
    which the arrays keep alive: it returns to the process's pinned cache when
    the fleet and every view of it are freed, and serves the next call of the
    same shape.  A fleet kept is never written by a later call, and keeps its
    page-locked memory: a user who keeps many fleets keeps all of theirs."""

    def __init__(self, action, columns, stats, final, index, weight=None, device='cuda',
                 mesh=None):
        self.Action = action
        self.device = device            # where the chains ran; their ensembles measure there
        self.mesh = mesh                # {'size': shards, 'kinds': [device kind of each]}
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


def _walk_worms(generator, cap=None):
    """Walk a generator tree once: give each ``ClassicWorm`` without a cap
    ``cap`` (where ``cap`` is not None).  Returns the tree (the same object
    where nothing changed), the uncapped worms that were replaced, and the stats
    tags of the capped worms in the returned tree, whose tallies count a
    step's worms (``sweeps``) and those that closed (``acceptance``)."""
    from ..generators import Logger, Sequentially, villain, worldline

    substituted, capped = [], []

    def walk(g, tag):
        if isinstance(g, Sequentially):
            parts = [walk(x, t) for x, t in zip(g.generators, g._tags)]
            changed = any(p is not x for p, x in zip(parts, g.generators))
            return Sequentially(parts) if changed else g
        if isinstance(g, KeepEvery):
            inner = walk(g.generator, tag)
            return g if inner is g.generator else \
                KeepEvery(g.n, inner, blocked_inline=g.blocked_inline)
        if isinstance(g, Logger):
            inner = walk(g.generator, tag)
            return g if inner is g.generator else Logger(inner, channel=g.channel, timer=g.timer)
        if isinstance(g, (villain.ClassicWorm, worldline.ClassicWorm)):
            if g.max_moves is None and cap is not None:
                substituted.append(g)
                g = type(g)(g.Action, max_moves=cap)
            if g.max_moves is not None:
                capped.append(tag or g.name)
        return g

    return walk(generator, None), substituted, capped


def _bounded_worms(generator, action, chains, policy):
    """Fleet worm-bounding policy.

    ``policy='raise'`` (default): a bare (unbounded) ClassicWorm in the tree
    with ``chains >= _WORM_BOUND_FLOOR`` is an error, naming what to pass
    instead.  ``policy='auto'``: rebuild the tree with
    ``ClassicWorm(max_moves=fleet_worm_cap)``, the cap of
    ``Hammer(S, fleet=True)`` (an exact bounded kernel: truncated worms roll
    back) and warn.  ``policy='off'``: pass through unchanged."""
    from ..generators.worldline import fleet_worm_cap

    if policy not in ('raise', 'auto', 'off'):
        raise ValueError(f"bound_worms must be 'raise', 'auto', or 'off', "
                         f'got {policy!r}')
    if policy == 'off' or chains < _WORM_BOUND_FLOOR:
        return generator

    cap = fleet_worm_cap(action.Lattice)
    rebuilt, changed, _ = _walk_worms(generator, cap)
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


def _checked_worms(generator, fleet):
    """``fleet``, its capped worms' truncated share checked against the budget
    (:func:`check_truncation_budget`, which warns) from its stats."""
    for tag in _walk_worms(generator)[2]:
        s = fleet.stats[tag]
        check_truncation_budget(s['sweeps'] - s['acceptance'], s['sweeps'],
                                context=f'sample_fleet {tag}: ')
    return fleet


def default_mesh(device):
    """The mesh of a fleet given none: :func:`.mesh.chain_mesh` over every card
    where the fleet runs on the card and more than one card or process is
    there, as the JAX package spans ``jax.devices()``; over this process's CPU
    in a group of processes; else ``device`` alone."""
    if device.type == 'cuda' and (torch.cuda.device_count() > 1 or distributed.world() > 1):
        return chain_mesh()
    if distributed.world() > 1:
        return chain_mesh([device])
    return ChainMesh([device])


def shard_generators(seed, shards, chains):
    """A :class:`..ops.shard.ShardGenerator` for each shard ``(device,
    block)``, each over a generator on the shard's device, seeded alike.  A
    ``torch.Generator`` passed as ``seed`` serves the first shard on its
    device, and the others start from a copy of its state.  Every shard draws
    the whole fleet's numbers, so all the generators stay in step and give the
    kernels the same seeds: each chain draws what it draws unsharded."""
    out = []
    for device, block in shards:
        if not isinstance(seed, torch.Generator):
            g = torch.Generator(device=device).manual_seed(int(seed))
        elif seed.device == device and not any(s.generator is seed for s in out):
            g = seed
        else:
            g = torch.Generator(device=device)
            g.set_state(seed.get_state())
        out.append(ShardGenerator(g, block.start, chains))
    return out


def host(tensors, bytes_counter=None):
    """A dict of tensors as NumPy arrays, copied in a ``fleet.copy`` span.
    Each copy from a card is a wait on it, counted in ``fleet.syncs``; the
    bytes copied are counted in ``bytes_counter`` where one is named."""
    with span('fleet.copy'):
        out = {}
        for k, v in tensors.items():
            if v.is_cuda:
                count('fleet.syncs')
            out[k] = v.cpu().numpy()
        if bytes_counter is not None:
            count(bytes_counter, sum(a.nbytes for a in out.values()))
        return out


def host_buffer(shape, dtype):
    """``(tensor, pinned)``: an uninitialised host tensor for copies from a card
    to land in, page-locked (``pinned``) where it can be.  Page-locked memory
    comes from the process's pinned cache, which gets back the block of a freed
    tensor and hands it out again at the next request of its size; what the
    cache had to pin anew is counted in ``fleet.pinned_new_bytes``.  Where
    pinning fails (page-locked memory runs out) the tensor is pageable, counted
    in ``fleet.pinned_fallbacks``."""
    before = _pinned_bytes_owned()
    try:
        tensor = torch.empty(shape, dtype=dtype, pin_memory=True)
    except RuntimeError:
        count('fleet.pinned_fallbacks')
        return torch.empty(shape, dtype=dtype), False
    count('fleet.pinned_new_bytes', _pinned_bytes_owned() - before)
    return tensor, True


def _pinned_bytes_owned():
    """Bytes the process's pinned cache has ever pinned."""
    return torch.cuda.host_memory_stats().get('allocated_bytes.allocated', 0)


class Landing:
    """Host arrays that copies of the cards' tensors land in, one a name of
    ``like`` (a shard's tensors), of shape ``lead`` + the tensor's shape past
    its chain axis and of its dtype: page-locked where they can be
    (:func:`host_buffer`)."""

    def __init__(self, like, lead):
        self.buffers = {k: host_buffer(tuple(lead) + tuple(v.shape[1:]), v.dtype)
                        for k, v in like.items()}

    def land(self, tensors, start, row=None, bytes_counter=None):
        """Queue, in a ``fleet.copy`` span, the copy of each of a shard's
        ``tensors`` into its array's chains from ``start`` on (in row ``row``
        where one is given), on the tensor's current stream.  A copy into
        page-locked memory returns at once, one into pageable memory when it
        is done (counted in ``fleet.syncs``).  The bytes copied are counted in
        ``bytes_counter`` where one is named, and those of them that land in
        page-locked memory in ``fleet.pinned_bytes`` too."""
        with span('fleet.copy'):
            for k, v in tensors.items():
                buffer, pinned = self.buffers[k]
                destination = (buffer if row is None else buffer[row])[start:start + len(v)]
                destination.copy_(v, non_blocking=True)
                if not pinned and v.is_cuda:
                    count('fleet.syncs')
                if bytes_counter is not None:
                    count(bytes_counter, destination.nbytes)
                    if pinned:
                        count('fleet.pinned_bytes', destination.nbytes)

    def arrays(self):
        """The arrays as NumPy views, which keep their host memory alive."""
        return {k: buffer.numpy() for k, (buffer, _) in self.buffers.items()}


def wait(device):
    """Wait, in a ``fleet.wait`` span, for the work queued on the current
    stream of ``device``: a card's (counted in ``fleet.syncs``); nothing on
    the CPU.  Before a shard's :func:`host` copies it parts the wait for its
    kernels from the copies, which would wait at the first of them anyway;
    after its :meth:`Landing.land` copies it waits for its kernels and copies."""
    with span('fleet.wait'):
        if device.type == 'cuda':
            torch.cuda.current_stream(device).synchronize()
            count('fleet.syncs')


def join(parts, axis=0):
    """Dicts of arrays joined key by key along ``axis`` (the chain axis), in order."""
    if len(parts) == 1:
        return parts[0]
    return {k: np.concatenate([p[k] for p in parts], axis=axis) for k in parts[0]}


def gathered_fleet(action, mesh, shards, columns, final, stats, index, device):
    """The :class:`Fleet` of every process's shards, in global chain order.
    ``columns`` (steps, c, ...), ``final`` (c, ...) and the per-chain ``stats``
    (c,) are this process's, of the c chains of its ``shards`` (None where it
    holds none); where there are several processes they are gathered in one
    collective.  The stats are then summed over all chains.  In a
    ``fleet.gather`` span."""
    with span('fleet.gather'):
        local = {'columns': columns, 'final': final, 'stats': stats, 'kinds': mesh.kinds(),
                 'blocks': [(block.start, len(block)) for _, block in shards]}
        parts = distributed.all_gather(local) if mesh.world > 1 else [local]
        blocks = [b for p in parts for b in p['blocks'] if b[1]]
        starts = [sum(c for _, c in blocks[:i]) for i in range(len(blocks))]
        if [start for start, _ in blocks] != starts:
            raise RuntimeError(f'the processes\' shards {blocks} do not tile the fleet: every '
                               'process must list as many devices')
        kinds = [k for p in parts for k in p['kinds']]
        parts = [p for p in parts if p['final'] is not None]
        columns = join([p['columns'] for p in parts], axis=1)
        final = join([p['final'] for p in parts])
        stats = {tag: join([p['stats'][tag] for p in parts]) for tag in parts[0]['stats']}
        return Fleet(action, columns, host_stats(stats), final, index, device=device,
                     mesh={'size': mesh.size, 'kinds': kinds})


def sample_fleet(action, generator, *, chains, steps, thin=1, seed=0, mesh=None, start='cold',
                 keep_fields=True, progress=None, bound_worms='raise', device='cuda'):
    """Sample ``chains`` independent chains for ``steps`` kept records, each
    separated by ``thin`` generator steps, on ``device`` (the card unless
    ``device='cpu'``) or over the shards of ``mesh``.

    Returns a :class:`Fleet`: the fields of every record (with
    ``keep_fields``) and the generator's inline observables, each averaged
    over its record's ``thin`` steps; the stats summed over chains; each
    chain's final configuration.  ``seed`` is an int that seeds a
    ``torch.Generator`` on ``device``, or such a generator itself.
    ``start`` is ``'cold'`` or a configuration dict every chain starts from.
    ``progress`` wraps the iteration over records.  ``bound_worms`` governs
    an unbounded ClassicWorm in the tree (see :func:`_bounded_worms`):
    ``'raise'`` (default), ``'auto'`` or ``'off'``.

    ``mesh`` (:func:`.mesh.chain_mesh`; by default :func:`default_mesh`) cuts
    the chains into contiguous blocks, uneven where they do not divide, one
    block a shard on its device and process.  A
    :func:`.mesh.chain_space_mesh` also cuts each chain's lattice into slabs
    (:mod:`.space`).  Every shard's record is queued
    before any is read back; no process talks to another until the records
    are done, and then every process returns the same :class:`Fleet`, in
    global chain order, equal bit for bit to the unsharded one.  Its capped
    worms' truncated share is then checked against :data:`TRUNCATION_BUDGET`
    (:func:`_checked_worms`, a warning)."""
    mesh = default_mesh(resolve_device(device)) if mesh is None else mesh
    generator = _bounded_worms(generator, action, chains, bound_worms)
    if getattr(mesh, 'space', 1) > 1:
        from .space import sample_space_fleet
        return _checked_worms(generator, sample_space_fleet(
            action, generator, chains=chains, steps=steps, thin=thin, seed=seed, mesh=mesh,
            start=start, keep_fields=keep_fields, progress=progress))
    shards = [(d, block) for d, block in mesh.shards(chains) if len(block)]
    rngs = shard_generators(seed, shards, chains)
    cfgs, statss = [], []
    for d, block in shards:
        cfg = action.initial(d) if start == 'cold' else \
            {k: to_device(start[k], d) for k in action.fields}
        cfgs.append(generator.prepare({k: v.expand((len(block),) + v.shape).contiguous()
                                       for k, v in cfg.items()}))
        statss.append(per_chain_stats(generator.init_stats(), len(block), d))

    # A record's inline values are averaged over its thin steps.
    record_step = KeepEvery(thin, generator)
    columns = None
    iterator = range(steps) if progress is None else progress(range(steps))
    for i in iterator:
        if not rngs:
            continue                # this process holds none of the chains
        inlines = []
        for k, rng in enumerate(rngs):
            cfgs[k], statss[k], inline = record_step.step(rng, cfgs[k], statss[k])
            inlines.append(inline)
        record = join([host((cfg if keep_fields else {}) | inline)
                       for cfg, inline in zip(cfgs, inlines)])
        if columns is None:
            columns = {k: np.empty((steps,) + v.shape, dtype=v.dtype) for k, v in record.items()}
        for k, v in record.items():
            columns[k][i] = v

    final = join([host(cfg) for cfg in cfgs]) if cfgs else None
    stats = {tag: join([host(s[tag]) for s in statss]) for tag in generator.init_stats()} \
        if statss else None
    index = thin * (1 + np.arange(steps))
    return _checked_worms(generator, gathered_fleet(action, mesh, shards, columns, final, stats,
                                                    index, mesh.devices[0]))
