"""Weak scaling of a fleet over cards, and the collectives inside its records.

PyTorch counterpart of :mod:`supervillain_tpu.benchmark.scaling`.  It runs the
Villain ``NeighborhoodUpdate`` at W=1 (kernel B1 on the card) through
:func:`..parallel.sample_fleet`, with chains in proportion to the cards (weak
scaling, the production regime), over the cards one process sees or over the
processes of a ``torchrun`` group, one card each:

    python -m supervillain_tpu_torch.benchmark.scaling [--json PATH]
    torchrun --nproc-per-node=K -m supervillain_tpu_torch.benchmark.scaling

On one card it prints one row and says so: shards that repeat one card run in
turn on it, and are a check of the plumbing, not scaling, so no efficiency is
given there.  Under ``torchrun`` the one-card row is process 0 alone on its
card, and the group's row starts every process at a barrier and is timed by
the slowest.  :func:`audit_collectives`, the counterpart of the JAX script's
count of collectives in the compiled step, reads the count of
:mod:`..parallel.distributed` over a sharded fleet's records: chains are
independent, so it must read 0 inside the records.
:func:`audit_space_collectives`, the counterpart of the JAX script's count of
collective permutes in a space-sharded Hammer step, counts the halo
exchanges, gathers and scatters of :mod:`..parallel.space` in one step of the
generic Villain ``Hammer(fleet=True)`` on a chain × space mesh: the halo
exchanges must be more than 0 (a count of 0 would mean that no update ran on
the slabs).  Every time is printed and written with the card's name and power
limit.
"""

from __future__ import annotations

import os
import subprocess
import time

import torch

from .. import tracing


def collectives():
    """The cross-process calls this process has made (``distributed.collective``)."""
    return tracing.counters().get('distributed.collective', 0)


def card():
    """The card's name and power limit as ``nvidia-smi`` gives them, or why not."""
    try:
        done = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                               '--format=csv,noheader'], capture_output=True, text=True)
    except OSError as e:
        return f'unavailable ({e})'
    if done.returncode != 0:
        return f'unavailable (nvidia-smi: {done.stderr.strip()})'
    return '; '.join(line.strip() for line in done.stdout.splitlines() if line.strip())


def _synchronize(mesh):
    for d in set(mesh.devices):
        if d.type == 'cuda':
            torch.cuda.synchronize(d)


def _sweeps_per_s(S, mesh, chains, steps):
    """Sweeps/s of ``chains`` chains over ``mesh`` in one record of ``steps``
    sweeps, after an untimed run: host clock from the record's start to the
    end of its work on every card (a synchronise), as the JAX script times its
    compiled step.  Over the processes of a group, every process starts the
    record at a barrier and the group is timed by its slowest process (one
    gather of the times, after the run).  Also the host cores this process
    kept busy meanwhile, the seconds of the whole run, the host copy and the
    gather of the final fields included, and each process's record seconds."""
    from ..generators import villain as gv
    from ..parallel import distributed, sample_fleet

    marks = []

    def watch(records):
        for i in records:
            _synchronize(mesh)
            if not marks and mesh.world > 1:
                distributed.barrier()
            marks.append((time.perf_counter(), time.process_time()))
            yield i
        _synchronize(mesh)
        marks.append((time.perf_counter(), time.process_time()))

    def run(seed, progress=None):
        return sample_fleet(S, gv.NeighborhoodUpdate(S), chains=chains, steps=1, thin=steps,
                            seed=seed, mesh=mesh, keep_fields=False, progress=progress)

    run(0)
    start = time.perf_counter()
    run(1, watch)
    whole = time.perf_counter() - start
    (t0, cpu0), (t1, cpu1) = marks
    cores = (cpu1 - cpu0) / max(t1 - t0, 1e-9)
    times = (distributed.all_gather((t1 - t0, whole)) if mesh.world > 1
             else [(t1 - t0, whole)])
    elapsed, whole = (max(x) for x in zip(*times))
    return chains * steps / elapsed, cores, whole, [t for t, _ in times]


def scaling_efficiency(N=32, chains_per_device=8, steps=10, device_counts=None, kappa=0.5,
                       device='cuda'):
    """Sweeps/s at 1, 2, 4, ... cards, chains growing with the cards, and the
    parallel efficiency against one card.  In a group of processes, one row
    of process 0 alone on its card (the others wait at a barrier) and one of
    the whole group, timed by its slowest process.  A single card gives one
    row and no efficiency."""
    import supervillain_tpu_torch as sv
    from ..device import resolve_device
    from ..parallel import distributed
    from ..parallel.mesh import ChainMesh, chain_mesh

    device = resolve_device(device)
    S = sv.Villain(sv.Lattice2D(N), kappa, W=1)
    world = distributed.world()
    if world > 1:
        own = chain_mesh([device] if device.type == 'cpu' else None)
        meshes = [ChainMesh(own.devices), own]
    else:
        devices = ([torch.device('cuda', i) for i in range(torch.cuda.device_count())]
                   if device.type == 'cuda' else [device])
        counts = device_counts or [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devices)]
        meshes = [ChainMesh(devices[:nd]) for nd in counts]
    where = card() if device.type == 'cuda' else 'cpu'
    say = print if distributed.rank() == 0 else (lambda *a, **k: None)
    say(f'{"devices":>8} {"chains":>7} {"sweeps/s":>12} {"su/s":>14} {"efficiency":>11} '
        f'{"cores busy":>11} {"eff/core":>9} {"run s":>9}   ({where})')
    shown = lambda x: '—' if x is None else f'{x:.1%}'
    results, base = [], None
    for mesh in meshes:
        chains = chains_per_device * mesh.size
        if world > 1 and mesh.world == 1:
            # The one-card row: process 0 alone, the others waiting in the gather.
            measured = _sweeps_per_s(S, mesh, chains, steps) if distributed.rank() == 0 else None
            rate, cores, whole, each = distributed.all_gather(measured)[0]
        else:
            rate, cores, whole, each = _sweeps_per_s(S, mesh, chains, steps)
        row = {'devices': mesh.size, 'chains': chains, 'sweeps_per_s': rate,
               'site_updates_per_s': rate * N * N, 'efficiency': None, 'cores_busy': cores,
               'efficiency_per_core': None, 'seconds_with_gather': whole,
               'record_seconds_by_process': each, 'card': where}
        if base is None:
            base = row
        elif mesh.size > 1:
            row['efficiency'] = rate / mesh.size / base['sweeps_per_s']
            if world == 1:      # cores_busy counts this process's cores only
                row['efficiency_per_core'] = ((rate / max(cores, 1e-9)) / (
                    base['sweeps_per_s'] / max(base['cores_busy'], 1e-9)))
        results.append(row)
        say(f'{mesh.size:>8} {chains:>7} {rate:>12.1f} {rate * N * N:>14.3e} '
            f'{shown(row["efficiency"]):>11} {cores:>11.2f} {shown(row["efficiency_per_core"]):>9} '
            f'{whole:>9.4f}')
    if len(meshes) == 1:
        say(f'one card ({where}): no scaling is measured on one card; shards that repeat it '
            'run in turn and check the plumbing only')
    return results


def audit_collectives(N=32, chains=64, steps=10, kappa=0.5, mesh=None, device='cuda'):
    """Count the cross-process calls of :mod:`..parallel.distributed` over a
    sharded fleet's records (``mesh``: :func:`..parallel.mesh.chain_mesh` by
    default).  Chains are independent Markov chains, so the records must make
    **none**: the only collective is the gather of the columns after them.
    Returns ``{'inside_records': n, 'after_records': n, 'records': steps,
    'shards': mesh size, 'processes': n}``."""
    import supervillain_tpu_torch as sv
    from ..generators import villain as gv
    from ..parallel import distributed, sample_fleet
    from ..parallel.mesh import chain_mesh

    mesh = chain_mesh() if mesh is None else mesh
    S = sv.Villain(sv.Lattice2D(N), kappa, W=1)
    seen = []

    def watch(records):
        for i in records:
            seen.append(collectives())
            yield i
        seen.append(collectives())

    sample_fleet(S, gv.NeighborhoodUpdate(S), chains=chains, steps=steps, seed=0, mesh=mesh,
                 progress=watch, keep_fields=False, device=device)
    return {'inside_records': seen[-1] - seen[0],
            'after_records': collectives() - seen[-1], 'records': steps,
            'shards': mesh.size, 'processes': distributed.world()}


def audit_space_collectives(N=32, space=4, kappa=0.5, W=2, device='cuda'):
    """Count the halo exchanges, slice and chain gathers and scatters of
    :mod:`..parallel.space`, and the cross-process calls, over one record of
    the generic Villain ``Hammer(fleet=True)`` on a 1 × ``space`` mesh of
    ``device`` listed ``space`` times (one chain).  The halo exchanges must be
    more than 0: the local updates run on the slabs."""
    import supervillain_tpu_torch as sv
    from ..generators import villain as gv
    from ..parallel import sample_fleet
    from ..parallel.mesh import chain_space_mesh

    names = {'halo_exchanges': 'space.halo_exchange', 'slice_gathers': 'space.gather_slices',
             'chain_gathers': 'space.gather_chain', 'chain_scatters': 'space.scatter_chain',
             'cross_process_calls': 'distributed.collective'}
    before = tracing.counters()
    S = sv.Villain(sv.Lattice2D(N), kappa, W=W)
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    sample_fleet(S, gv.Hammer(S, fleet=True), chains=1, steps=1, seed=0,
                 mesh=chain_space_mesh(1, space, [device] * space), keep_fields=False)
    after = tracing.counters()
    return {k: after.get(name, 0) - before.get(name, 0) for k, name in names.items()} | {
        'N': N, 'space': space, 'steps': 1}


if __name__ == '__main__':
    import argparse
    import json

    from ..parallel import distributed
    from ..parallel.mesh import chain_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument('--N', type=int, default=32)
    ap.add_argument('--chains-per-device', type=int, default=8)
    ap.add_argument('--steps', type=int, default=10)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (the cards) or 'cpu' (a rehearsal: host times, no card's)")
    ap.add_argument('--json', type=str, default=None,
                    help='Write the results (scaling table + collective audit) to this path.')
    args = ap.parse_args()
    if 'WORLD_SIZE' in os.environ and int(os.environ['WORLD_SIZE']) > 1:
        distributed.initialize()
    table = scaling_efficiency(N=args.N, chains_per_device=args.chains_per_device,
                               steps=args.steps, device=args.device)
    mesh = chain_mesh(['cpu'] if args.device == 'cpu' else None)
    collectives = audit_collectives(N=args.N, chains=args.chains_per_device * mesh.size,
                                    mesh=mesh, device=args.device)
    space_collectives = (audit_space_collectives(N=args.N, device=args.device)
                         if distributed.world() == 1 else
                         {'unavailable': 'the space audit runs in one process'})
    if distributed.rank() == 0:
        print('collectives inside the sharded fleet\'s records:', collectives)
        print('halo exchanges, gathers and scatters in a space-sharded Hammer step:',
              space_collectives)
    if args.json and distributed.rank() == 0:
        where = card() if args.device == 'cuda' else 'cpu'
        payload = {
            'config': {'N': args.N, 'chains_per_device': args.chains_per_device,
                       'steps': args.steps, 'backend': torch.device(args.device).type,
                       'devices': mesh.size, 'host_physical_cores': os.cpu_count(),
                       'card': where},
            'weak_scaling': table,
            'collectives_in_compiled_step': collectives,
            'collectives_in_space_sharded_step': space_collectives,
            'note': ('Chains are independent: a sharded fleet makes no cross-process '
                     'call inside its records (collectives_in_compiled_step counts the '
                     'calls of parallel/distributed.py), and gathers its columns once '
                     'after them. One card gives one row and no efficiency: shards that '
                     'repeat a card run in turn on it. sweeps_per_s times the record alone '
                     '(host clock, ending in a synchronise of every card), as the JAX script '
                     'times its compiled step; over processes, the record starts at a '
                     'barrier and the slowest process times the group, and the one-card row '
                     'is process 0 alone; seconds_with_gather is the whole run, the '
                     'host copy and the gather of the final fields included. On the card '
                     'named in config.card.'),
        }
        with open(args.json, 'w') as f:
            json.dump(payload, f, indent=1)
        print(f'wrote {args.json}')
