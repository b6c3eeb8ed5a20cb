"""Sampling a batch of chains with the fused kernels.

PyTorch counterpart of
:func:`supervillain_tpu.parallel.fused_fleet.sample_fused_fleet`, for both
formulations: a Villain action drives the neighborhood / Hammer kernels over
(φ, n), a Worldline action the vortex+coexact+wrapping / worldline-Hammer
kernels over (m, v).  The chain batch is the leading tensor axis of each
shard's fields; every call advances all chains ``thin`` sweeps (and, with
``worms > 0``, that many worms) and returns inline observables measured in the
call.  On a GPU the calls run the CUDA kernels; on the CPU the plain versions.
With a chain mesh (:mod:`.mesh`) each shard runs its block of chains on its
device, its kernels counting their Philox streams from its first chain's
global index, so the fleet equals the unsharded one bit for bit.  A call's
host work runs in the spans of :mod:`..tracing` (``fleet.call``, and inside
it ``fleet.init``, a ``fleet.record`` a record and ``fleet.finish``), which a
recording ``torch.profiler`` keeps; its records, copies and waits are counted
there whether or not one records.  On cards each copy to the host is queued on
its shard's stream right after the shard's launch and lands in page-locked
memory that is the returned fleet's own column or final field
(:class:`.fleet.Landing`); a record then waits once a shard.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import field_dtypes, resolve_device
from ..models import Villain, Worldline
from ..ops.hammer import hammer_sweeps
from ..ops.shard import ShardGenerator
from ..ops.sweep import neighborhood_sweeps
from ..ops.worldline import action_density, worldline_sweeps
from ..ops.worldline_hammer import worldline_hammer_sweeps
from ..tracing import count, span
from .fleet import Landing, check_truncation_budget, gathered_fleet, host, join, wait
from .mesh import ChainMesh

def _villain_launch(action, *, thin, interval_phi, interval_n, p_n, worms, max_worm_moves):
    """(phi, n, generator) -> (phi, n, accepted, inline) for one record."""
    common = dict(kappa=action.kappa, W=action.W, interval_phi=float(interval_phi),
                  interval_n=int(interval_n), sweeps=thin,
                  p_n=None if p_n is None else float(p_n))
    if worms > 0:
        return lambda phi, n, rng: hammer_sweeps(phi, n, worms=int(worms),
                                                 max_worm_moves=max_worm_moves,
                                                 generator=rng, **common)
    return lambda phi, n, rng: neighborhood_sweeps(phi, n, generator=rng, **common)


def _worldline_launch(action, *, thin, worms, max_worm_moves):
    """(m, v, generator) -> (m, v, accepted, inline) for one record.  Without
    worms the sweep returns no inline column the fleet keeps: ActionDensity,
    (1/2κ)Σu²/Λ, is measured on the kept state after the call, as the JAX
    package does."""
    common = dict(kappa=action.kappa, W=action.W, sweeps=thin)
    if worms > 0:
        return lambda m, v, rng: worldline_hammer_sweeps(m, v, worms=int(worms),
                                                         max_worm_moves=max_worm_moves,
                                                         generator=rng, **common)

    def launch(m, v, rng):
        m, v, accepted, _ = worldline_sweeps(m, v, generator=rng, **common)
        return m, v, accepted, {'ActionDensity': action_density(m, v, action.kappa, action.W)}
    return launch


def lands_pinned(shards):
    """Whether a fleet's copies land in page-locked columns: where every shard
    is on a card."""
    return all(d.type == 'cuda' for d, _ in shards)


def _store(columns, i, steps, shards, inlines):
    """Record ``i`` of CPU shards: each shard's inline tensors copied to NumPy
    after its wait, joined over the shards and written into ``columns``
    (``(steps, chains, ...)`` arrays, made at the first record); returns them."""
    parts = []
    for (d, _), inline in zip(shards, inlines):
        wait(d)
        parts.append(host(inline, 'fleet.host_bytes'))
    with span('fleet.store'):
        record = join(parts)
        if columns is None:
            columns = {k: np.empty((steps,) + v.shape, dtype=v.dtype) for k, v in record.items()}
        for k, v in record.items():
            columns[k][i] = v
    return columns


def sample_fused_fleet(action, *, chains, steps, thin=10, seed=0, interval_phi=np.pi,
                       interval_n=1, p_n=None, keep_fields=False, progress=None, worms=0,
                       max_worm_moves='auto', mesh=None, device='cuda'):
    """Sample ``chains`` chains of a Villain or Worldline action for ``steps``
    kept records, each separated by ``thin`` fused sweeps, on ``device`` (the
    card unless ``device='cpu'``) or over the shards of ``mesh``.

    Returns a :class:`Fleet` whose columns are the inline observables (and the
    fields, if ``keep_fields``).  ``worms > 0`` runs the fused Hammer: every
    record's sweeps are followed by that many worms per chain, adding the worm
    histogram (``Vortex_Vortex`` for Villain, ``Spin_Spin`` for Worldline),
    ``Worm_Length`` and ``Worm_Truncated`` columns.  Worms are capped at 64·N²
    moves by default (exact rollback of an unclosed worm where it would break
    the constraint); pass ``max_worm_moves=None`` for unbounded worms.  A
    Worldline fleet's inline ``ActionDensity`` is the kernels'
    (1/2κ)Σ(m − δv/_W)²/Λ, 1 minus the registry observable of that name in D=2;
    ``interval_phi``, ``interval_n`` and ``p_n`` are Villain options.  ``seed``
    seeds the host ``torch.Generator`` that draws every call's randomness (the
    kernels' seeds, so that no launch waits for the card; on the CPU, every
    draw).

    ``mesh`` (:func:`.mesh.chain_mesh`) cuts the chains into equal contiguous
    blocks, one a shard on its device and process; ``chains`` must divide by
    ``mesh.size``.  Every shard's calls are launched before any record is read
    back; no process talks to another until the records are done, and then
    every process returns the same :class:`Fleet`, in global chain order,
    equal bit for bit to the unsharded one.

    On cards the fleet's columns and final fields are NumPy views of
    page-locked host memory, which every copy from a card lands in directly.
    That memory returns to the process's pinned cache when the fleet is freed,
    and the next call of the same shape takes it from there without pinning
    anew; a user who keeps many fleets keeps all their page-locked memory.
    Where pinning fails, a buffer is pageable and its copies wait."""
    worldline = isinstance(action, Worldline)
    if not (worldline or isinstance(action, Villain)):
        raise ValueError('sample_fused_fleet drives a Villain or a Worldline action')
    if getattr(mesh, 'space', 1) > 1:
        raise ValueError('sample_fused_fleet keeps each chain whole on one card, as the Pallas '
                         'kernels keep it in one chip\'s memory: a mesh with a space axis runs '
                         'the generic updates through sample_fleet')
    if mesh is None:
        mesh = ChainMesh([resolve_device(device)])
    elif chains % mesh.size:
        raise ValueError(f'{chains} chains not divisible by {mesh.size} mesh devices')
    L = action.Lattice
    N = L.N
    if max_worm_moves == 'auto':
        max_worm_moves = 64 * N * N if worms > 0 else None
    if worldline:
        names = ('m', 'v')
        launch = _worldline_launch(action, thin=thin, worms=worms, max_worm_moves=max_worm_moves)
        per_sweep = 2 * L.sites + 2 * N
        tag = 'WorldlineLocalUpdates'
    else:
        names = ('phi', 'n')
        launch = _villain_launch(action, thin=thin, interval_phi=interval_phi,
                                 interval_n=interval_n, p_n=p_n, worms=worms,
                                 max_worm_moves=max_worm_moves)
        per_sweep = L.sites
        tag = 'NeighborhoodUpdate'

    with span('fleet.call'):
        with span('fleet.init'):
            shards = mesh.shards(chains)
            fields, accepted, rngs = [], [], []
            for d, block in shards:
                fdt, idt = field_dtypes(d)
                B = len(block)
                if worldline:
                    vdt = fdt if action.W == float('inf') else idt
                    fields.append((torch.zeros((B, 2, N, N), dtype=idt, device=d),
                                   torch.zeros((B, 1, N, N), dtype=vdt, device=d)))
                else:
                    fields.append((torch.zeros((B, 1, N, N), dtype=fdt, device=d),
                                   torch.zeros((B, 2, N, N), dtype=idt, device=d)))
                accepted.append(torch.zeros(B, dtype=torch.float64, device=d))
                # Each shard's host generator, seeded alike, draws what the whole
                # fleet's would: the same kernel seeds, and the fleet's rows.
                rngs.append(ShardGenerator(torch.Generator().manual_seed(int(seed)), block.start,
                                           chains))

        # CPU shards keep the copy, join and store (there is no card to pin
        # host memory for), so their spans and counts are unchanged.
        pinned = lands_pinned(shards)
        offsets = [block.start - shards[0][1].start for _, block in shards]
        local = sum(len(block) for _, block in shards)
        columns = None
        iterator = range(steps) if progress is None else progress(range(steps))
        for i in iterator:
            with span('fleet.record'):
                count('fleet.records')
                inlines = []
                for k, rng in enumerate(rngs):
                    with span('fleet.launch'):
                        a, b, acc, inline = launch(*fields[k], rng)
                        fields[k] = (a, b)
                        accepted[k] = accepted[k] + acc.to(torch.float64)
                    inlines.append(inline | (dict(zip(names, fields[k])) if keep_fields else {}))
                    if pinned:
                        if k == 0:
                            with span('fleet.store'):
                                if columns is None:
                                    columns = Landing(inlines[0], (steps, local))
                        columns.land(inlines[k], offsets[k], i, 'fleet.host_bytes')
                if pinned:
                    for d, _ in shards:
                        wait(d)
                else:
                    columns = _store(columns, i, steps, shards, inlines)

        with span('fleet.finish'):
            if pinned:
                with span('fleet.final'):
                    final = Landing(dict(zip(names, fields[0])), (local,))
                    stats = Landing({'accepted': accepted[0]}, (local,))
                    for k, f in enumerate(fields):
                        final.land(dict(zip(names, f)), offsets[k],
                                   bytes_counter='fleet.final_bytes')
                        stats.land({'accepted': accepted[k]}, offsets[k])
                    for d, _ in shards:
                        wait(d)
                columns = None if columns is None else columns.arrays()
                final, stats = final.arrays(), {tag: stats.arrays()}
            else:
                stats = {tag: join([host({'accepted': acc}) for acc in accepted])}
                with span('fleet.final'):
                    final = join([host(dict(zip(names, f)), 'fleet.final_bytes')
                                  for f in fields])
            index = thin * (1 + np.arange(steps))
            fleet = gathered_fleet(action, mesh, shards, columns, final, stats, index,
                                   mesh.devices[0])
            total = fleet.stats[tag]['accepted']
            proposals = chains * per_sweep * thin * steps
            fleet.stats[tag] = {'accepted': total, 'proposed': float(proposals),
                                'acceptance': total / proposals, 'sweeps': float(thin * steps)}
            if fleet.columns is not None and 'Worm_Truncated' in fleet.columns:
                check_truncation_budget(fleet.columns['Worm_Truncated'].sum(),
                                        worms * steps * chains, context='sample_fused_fleet: ')
        return fleet
