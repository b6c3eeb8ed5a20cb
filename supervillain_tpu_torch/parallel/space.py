"""The ``space`` axis: one chain's lattice split over devices, with halo exchange.

PyTorch counterpart of the ``space`` axis of :mod:`supervillain_tpu.parallel.mesh`
(``chain_space_mesh``, ``fleet_sharding(..., spatial=True)``).  Where XLA's
partitioner inserts the halo permutes of the roll stencils itself, the port
runs them here, on a :class:`.mesh.ChainSpaceMesh`: each row of the mesh holds
a block of chains, and each of its ``space`` shards a slab of every chain's
last axis, ``N / space`` columns wide, padded with :data:`GHOST` columns of the
neighbouring slabs on either side (:class:`..ops.shard.Slab`).

A step runs each update of the generator tree on every slab of a row:

- a local update (:class:`..generators.base.PassUpdate`: the checkerboarded
  updates, ``LinkUpdate`` and ``NeighborhoodUpdate``) runs its own code on
  each padded slab, pass by pass, with a halo exchange (:func:`halo_exchange`)
  before the step and before each later pass.  The ghosts then hold the
  neighbours' current values, and the first ghost column's sites update
  with their own draws, so the slab's boundary links change as they do on
  the whole torus.  ``NeighborhoodUpdate`` runs B1's slab entry on the card
  (:func:`..ops.sweep.slab_pass`);
- ``CohomologyUpdate``, whose ΔS sums the residual over the slices x_μ = 0,
  gathers each slab's part of them (B·N numbers, :func:`gather_slices`) to
  every slab, which reduces them with the same call as unsharded, makes the
  same decisions and changes its own links;
- any other update (the worms, whose walk crosses the whole torus, and the
  Worldline ``WrappingUpdate``, whose ΔS sums whole cycles in both
  directions, as many link terms as the chain holds) runs unchanged on the
  chain gathered to the shard that holds column 0 (:func:`gather_chain`),
  and its result is scattered back (:func:`scatter_chain`): the same call on
  the same numbers as unsharded.  This is a limit of the axis: such an
  update runs on one device.

Every draw is made for the whole fleet and the whole torus and cut to the
slab (:class:`..ops.shard.SlabGenerator`); the kernels count their Philox
streams by the global site and chain.  So a sharded fleet's fields equal the
unsharded fleet's bit for bit, and its stats agree to the rounding of sums
over slabs.  The generators of a row's slabs, seeded alike, stay in step:
after a gathered update the others take the column-0 slab's state.

A row whose slabs lie in more than one process moves its halos, gathers
and sums as host data through its process group (:mod:`.distributed`,
counted); a row inside one process moves device tensors.  Each halo
exchange, gather and scatter counts one call of its function.  The space axis
is D=2: the slabs cut the last of two axes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import to_device
from ..generators import KeepEvery, Logger, Sequentially
from ..generators.base import Generator, PassUpdate, host_stats, per_chain_stats
from ..generators.villain import CohomologyUpdate
from ..ops.shard import Slab, SlabGenerator
from ..tracing import count
from . import distributed
from .mesh import ChainSpaceMesh, fleet_sharding, slab_width

#: Ghost columns on each side of a slab: a pass's site reads its links'
#: neighbours one column away, and the first ghost column's sites are updated
#: too (they change the slab's own boundary links), so they read one further.
GHOST = 2


def _spatial(value, slab):
    """Whether ``value`` is a field over the slab's sites or links."""
    return (isinstance(value, torch.Tensor) and value.dim() >= 3 and value.shape[-2] == slab.N
            and value.shape[-1] in (slab.width, slab.padded))


def _own(value, slab):
    return slab.own(value) if value.shape[-1] == slab.padded else value


def _host(obj):
    """``obj`` with every tensor copied to the host (to send it to a process)."""
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _to(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    return obj


class Row:
    """One row of a chain × space mesh as this process holds it: its block of
    chains and its slabs here, ``local`` as (slab index, device, Slab).  The
    row's ``device`` keeps its stats: the column-0 slab's where it is here."""

    def __init__(self, index, block, space, local, group):
        self.index, self.block, self.space = index, block, space
        self.local = local
        self.group = group
        self.holds_col0 = local[0][0] == 0
        self.device = local[0][1]

    def share(self, contributions):
        """Every slab's ``contributions`` (a dict keyed by slab, or any dict
        that the processes' keys do not overlap in): this process's own, and
        over the row's process group the others', as host copies."""
        if self.group is None:
            return contributions
        merged = {}
        for part in distributed.all_gather(_host(contributions), self.group):
            merged.update(part)
        return merged

    def total(self, values):
        """Σ over the row's slabs, in slab order, of each local slab's value
        (a per-chain tensor, or 0), on the row's device."""
        if all(isinstance(v, (int, float)) for v in values):
            return sum(values)
        shared = self.share({s: v for (s, _, _), v in zip(self.local, values)})
        out = 0
        for s in range(self.space):
            out = out + _to(shared[s], self.device)
        return out


class RowGenerators:
    """The argument ``generator`` of a step on a row: each local slab's
    :class:`..ops.shard.SlabGenerator`, seeded alike.  The step's ``cfg`` is
    the list of each local slab's fields, its own columns only (and any field
    that is not over the lattice, such as an open worm, whole on every slab)."""

    def __init__(self, row, generators):
        self.row, self.generators = row, list(generators)

    def sync(self, state):
        """Every local slab's generator but column 0's takes ``state``."""
        for (s, _, _), g in zip(self.row.local, self.generators):
            if s != 0:
                g.generator.set_state(state)


def halo_exchange(row, states):
    """Pad each local slab's fields with :data:`GHOST` columns of its
    neighbours' own columns on either side (the torus wraps: slab 0's left
    neighbour is the last).  ``states``: a dict a slab, its fields padded or
    not; other entries pass through.  Counted in ``space.halo_exchange``
    (:mod:`..tracing`)."""
    count('space.halo_exchange')
    own = [{k: _own(v, slab) for k, v in st.items() if _spatial(v, slab)}
           for (_, _, slab), st in zip(row.local, states)]
    edges = row.share({s: ({k: v[..., :GHOST] for k, v in o.items()},
                           {k: v[..., -GHOST:] for k, v in o.items()})
                       for (s, _, _), o in zip(row.local, own)})
    out = []
    for (s, device, _), st, o in zip(row.local, states, own):
        left, right = edges[(s - 1) % row.space][1], edges[(s + 1) % row.space][0]
        out.append(st | {k: torch.cat([left[k].to(device), v, right[k].to(device)], dim=-1)
                         for k, v in o.items()})
    return out


def gather_chain(row, cfgs):
    """The row's chains whole, on the column-0 slab's device (None where this
    process does not hold it): the slabs' columns joined in order.  Counted
    in ``space.gather_chain`` (:mod:`..tracing`)."""
    count('space.gather_chain')
    shared = row.share({s: cfg for (s, _, _), cfg in zip(row.local, cfgs)})
    if not row.holds_col0:
        return None
    device, slab = row.local[0][1], row.local[0][2]
    return {k: torch.cat([_to(shared[s][k], device) for s in range(row.space)], dim=-1)
            if _spatial(v, slab) else v for k, v in shared[0].items()}


def scatter_chain(row, result):
    """Each local slab's columns of the column-0 slab's ``result`` (the
    gathered step's fields, stats, inline values and generator state), and
    the stats and inline values on the row's device.  Counted in
    ``space.scatter_chain`` (:mod:`..tracing`)."""
    count('space.scatter_chain')
    payload = {}
    if result is not None:
        cfg, stats, inline, state = result
        N, width = row.local[0][2].N, row.local[0][2].width
        pieces = {s: {k: v[..., s * width:(s + 1) * width]
                      if isinstance(v, torch.Tensor) and v.dim() >= 3 and v.shape[-2:] == (N, N)
                      else v for k, v in cfg.items()} for s in range(row.space)}
        payload = {'scattered': (pieces, stats, inline, state)}
    pieces, stats, inline, state = row.share(payload)['scattered']
    cfgs = [_to(pieces[s], device) for s, device, _ in row.local]
    return cfgs, _to(stats, row.device), _to(inline, row.device), state


def pass_step(update, generators, cfgs, stats):
    """One step of a local update on a row: a halo exchange, then each pass on
    every slab with a halo exchange before each but the first, then the
    slabs' own columns and the row's summed tallies."""
    row = generators.row
    states = [update.begin(g, cfg) for g, cfg in
              zip(generators.generators, halo_exchange(row, cfgs))]
    accepted = [0] * len(states)
    acceptance = [0] * len(states)
    for i, key in enumerate(update.pass_keys()):
        if i:
            states = halo_exchange(row, states)
        for j, g in enumerate(generators.generators):
            states[j], a, p = update.run_pass(g, states[j], key)
            accepted[j], acceptance[j] = accepted[j] + a, acceptance[j] + p
    cfgs = [update.finish(cfg, {k: _own(v, slab) if _spatial(v, slab) else v
                                for k, v in st.items()})
            for (_, _, slab), cfg, st in zip(row.local, cfgs, states)]
    stats = update.tally(stats, len(row.block), row.total(accepted), row.total(acceptance))
    return cfgs, stats, {}


def gather_slices(row, pieces):
    """Every slab's parts of the slices x_μ = 0 (``pieces``: a list over μ
    for each local slab), joined in slab order into the whole slices on each
    local slab's device.  Counted in ``space.gather_slices``
    (:mod:`..tracing`)."""
    count('space.gather_slices')
    shared = row.share({s: p for (s, _, _), p in zip(row.local, pieces)})
    return [[torch.cat([_to(shared[s][mu], device) for s in range(row.space)], dim=1)
             for mu in range(len(shared[0]))] for _, device, _ in row.local]


def slice_step(update, generators, cfgs, stats):
    """One step of ``CohomologyUpdate`` on a row: its ΔS sums the residual
    over the slices x_μ = 0, so each slab's part of every slice (B·N numbers
    in all) is gathered to every slab, each makes the same decisions from the
    whole slices with the same call as unsharded (drawing through its
    generator's whole-chain view), and changes its own links."""
    row = generators.row
    slices = gather_slices(row, [update.slices(cfg, slab)
                                 for (_, _, slab), cfg in zip(row.local, cfgs)])
    decided = [update.decide(g.chains_view(), whole, cfg['n'].dtype)
               for g, whole, cfg in zip(generators.generators, slices, cfgs)]
    cfgs = [update.apply(cfg, decisions, slab)
            for (_, _, slab), cfg, decisions in zip(row.local, cfgs, decided)]
    return cfgs, update.tally(stats, decided[0]), {}


def gathered_step(update, generators, cfgs, stats):
    """One step of an update that is not local on a row: run unchanged on the
    chains gathered to the column-0 slab, which draws through its
    generator's whole-chain view, and scattered back."""
    row = generators.row
    full = gather_chain(row, cfgs)
    result = None
    if full is not None:
        g = generators.generators[0].chains_view()
        cfg, stats, inline = update.step(g, full, stats)
        result = (cfg, stats, inline, g.generator.get_state())
    cfgs, stats, inline, state = scatter_chain(row, result)
    generators.sync(state)
    return cfgs, stats, inline


class OnSlabs(Generator):
    """A leaf of a generator tree run on the slabs of a row: a
    :class:`..generators.base.PassUpdate` by :func:`pass_step`,
    ``CohomologyUpdate`` by :func:`slice_step`, any other update by
    :func:`gathered_step`."""

    def __init__(self, generator):
        self.generator = generator
        self.name = generator.name

    def init_stats(self):
        return self.generator.init_stats()

    def step(self, generators, cfgs, stats):
        if isinstance(self.generator, PassUpdate):
            run = pass_step
        elif isinstance(self.generator, CohomologyUpdate):
            run = slice_step
        else:
            run = gathered_step
        return run(self.generator, generators, cfgs, stats)


def on_slabs(generator):
    """``generator``'s tree with each leaf run on a row's slabs (:class:`OnSlabs`):
    ``Sequentially``, ``KeepEvery`` and ``Logger`` keep their own code."""
    if isinstance(generator, Sequentially):
        return Sequentially([on_slabs(g) for g in generator.generators])
    if isinstance(generator, KeepEvery):
        return KeepEvery(generator.n, on_slabs(generator.generator),
                         blocked_inline=generator.blocked_inline)
    if isinstance(generator, Logger):
        return Logger(on_slabs(generator.generator), channel=generator.channel,
                      timer=generator.timer)
    return OnSlabs(generator)


def rows(mesh, chains, N):
    """This process's :class:`Row` s of ``mesh`` for ``chains`` chains on a
    torus of side ``N``, in order."""
    if not isinstance(mesh, ChainSpaceMesh):
        raise ValueError(f'the space axis runs on a ChainSpaceMesh, not {mesh!r}')
    shards = fleet_sharding(mesh, chains, spatial=True, N=N)
    by_row = {}
    for device, (row, s) in zip(mesh.devices, mesh.places()):
        columns = shards[row * mesh.space + s][1]
        by_row.setdefault(row, []).append((s, device, Slab(N, columns.start, len(columns), GHOST)))
    return [Row(row, shards[row * mesh.space][0], mesh.space, local, mesh.groups[row])
            for row, local in sorted(by_row.items())]


def row_generators(seed, row, chains):
    """Each local slab's :class:`..ops.shard.SlabGenerator`, over a generator on
    its device seeded alike (``seed`` an int, or a ``torch.Generator`` whose
    state each starts from)."""
    out = []
    for _, device, slab in row.local:
        if isinstance(seed, torch.Generator):
            g = torch.Generator(device=device)
            g.set_state(seed.get_state())
        else:
            g = torch.Generator(device=device).manual_seed(int(seed))
        out.append(SlabGenerator(g, row.block.start, chains, slab))
    return RowGenerators(row, out)


def _cut(cfg, slab):
    """A starting configuration's fields cut to the slab's own columns."""
    return {k: v[..., slab.col0:slab.col0 + slab.width].contiguous()
            if isinstance(v, torch.Tensor) and v.dim() >= 3 and v.shape[-2:] == (slab.N, slab.N)
            else v for k, v in cfg.items()}


def sample_space_fleet(action, generator, *, chains, steps, thin, seed, mesh, start,
                       keep_fields, progress):
    """:func:`.fleet.sample_fleet` over a chain × space mesh: every row's
    chains stepped on its slabs in turn, each record's slab columns kept
    where they ran, and after the records one gather of every process's
    pieces into the :class:`.fleet.Fleet`, equal bit for bit in its fields to
    the unsharded one."""
    from .fleet import Fleet, join

    L = action.Lattice
    if L.D != 2:
        raise NotImplementedError('the space axis is implemented for D=2')
    if mesh.space > 1 and len({torch.device(d).type for d in mesh.devices}) != 1:
        raise ValueError('the slabs of a chain × space mesh lie on devices of one kind')
    width = slab_width(L.N, mesh.space)
    tree = on_slabs(KeepEvery(thin, generator))
    runs = []
    for row in rows(mesh, chains, L.N):
        if not len(row.block):
            continue
        B = len(row.block)
        gens = row_generators(seed, row, chains)
        cfgs = []
        for _, device, slab in row.local:
            cfg = action.initial(device) if start == 'cold' else \
                {k: to_device(start[k], device) for k in action.fields}
            cfg = generator.prepare({k: v.expand((B,) + v.shape).contiguous()
                                     for k, v in cfg.items()})
            cfgs.append(_cut(cfg, slab))
        stats = per_chain_stats(generator.init_stats(), B, row.device)
        runs.append([row, gens, cfgs, stats, []])

    iterator = range(steps) if progress is None else progress(range(steps))
    for _ in iterator:
        for run in runs:
            row, gens, cfgs, stats, records = run
            cfgs, stats, inline = tree.step(gens, cfgs, stats)
            records.append(([{k: v.cpu().numpy() for k, v in cfg.items() if keep_fields}
                             for cfg in cfgs],
                            {k: v.cpu().numpy() for k, v in inline.items()}))
            run[2], run[3] = cfgs, stats

    local = {'kinds': mesh.kinds(), 'pieces': {}, 'rows': {}}
    for row, _, cfgs, stats, records in runs:
        for i, (s, _, _) in enumerate(row.local):
            local['pieces'][(row.index, s)] = (
                {k: np.stack([r[0][i][k] for r in records]) for k in records[0][0][i]}
                if records else {},
                {k: v.cpu().numpy() for k, v in cfgs[i].items()})
        if row.holds_col0:
            local['rows'][row.index] = (
                {k: np.stack([r[1][k] for r in records]) for k in records[0][1]} if records else {},
                {tag: {k: v.cpu().numpy() for k, v in s.items()} for tag, s in stats.items()})
    parts = distributed.all_gather(local) if mesh.world > 1 else [local]
    pieces, row_parts, kinds = {}, {}, []
    for p in parts:
        pieces.update(p['pieces'])
        row_parts.update(p['rows'])
        kinds += p['kinds']

    def whole(row, which):
        """The row's fields joined over its slabs (a field not over the
        lattice from slab 0)."""
        first = pieces[(row, 0)][which]
        return {k: np.concatenate([pieces[(row, s)][which][k] for s in range(mesh.space)],
                                  axis=-1) if v.ndim >= 3 and v.shape[-2:] == (L.N, width) else v
                for k, v in first.items()}

    filled = [row for row in range(mesh.chains_axis) if row in row_parts]
    columns = join([whole(row, 0) | row_parts[row][0] for row in filled], axis=1)
    final = join([whole(row, 1) for row in filled])
    stats = {tag: join([row_parts[row][1][tag] for row in filled])
             for tag in generator.init_stats()}
    index = thin * (1 + np.arange(steps))
    return Fleet(action, columns, host_stats(stats), final, index, device=mesh.devices[0],
                 mesh={'size': mesh.size, 'kinds': kinds,
                       'shape': (mesh.chains_axis, mesh.space)})


__all__ = ['GHOST', 'OnSlabs', 'Row', 'RowGenerators', 'gather_chain', 'gather_slices',
           'gathered_step', 'halo_exchange', 'on_slabs', 'pass_step', 'row_generators', 'rows',
           'sample_space_fleet', 'scatter_chain', 'slice_step']
