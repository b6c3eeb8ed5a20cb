"""Processes of a fleet: ``torch.distributed`` over the gloo backend.

PyTorch counterpart of :mod:`supervillain_tpu.parallel.distributed`.  Call
:func:`initialize` once in each process (one per card, as ``torchrun`` starts
them) before building meshes; :func:`..mesh.chain_mesh` then spans every
process, and both fleets split their chains over all of them.

No device data crosses processes.  Chains are independent Markov chains, so a
record runs with no communication at all; what is aggregated (the stats, and
the columns and final configurations once at the end of a run) is host data,
as in the JAX package.  So the group runs on the gloo backend, over the host,
on any machine.  Every cross-process call goes through :func:`collective`,
which counts them: :func:`..benchmark.scaling.audit_collectives` reads the
count.
"""

from __future__ import annotations

import os

import torch

from ..tracing import count


def _dist():
    import torch.distributed as dist
    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's index in the group (0 without one)."""
    return _dist().get_rank() if is_initialized() else 0


def world() -> int:
    """The processes of the group (1 without one)."""
    return _dist().get_world_size() if is_initialized() else 1


def is_multi_host() -> bool:
    return world() > 1


def _from_env(name):
    value = os.environ.get(name)
    if value is None:
        raise RuntimeError(f'initialize() needs {name}: pass the argument, or start the '
                           'processes with torchrun, which sets it')
    return value


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """``torch.distributed.init_process_group`` on gloo.  Arguments that are
    None come from the ``torchrun`` environment, as JAX discovers them on a
    pod: the coordinator ``MASTER_ADDR:MASTER_PORT`` (an address with a
    scheme, such as ``file:///tmp/init``, is used as the ``init_method``), the
    processes ``WORLD_SIZE`` and this one's ``RANK``.  Where there is a card,
    the process takes card ``LOCAL_RANK % device_count`` (``LOCAL_RANK``
    defaulting to the rank).  Returns (rank, processes, cards in the world: one
    a process, or 0 without a card)."""
    if coordinator_address is None:
        coordinator_address = f'{_from_env("MASTER_ADDR")}:{_from_env("MASTER_PORT")}'
    address = str(coordinator_address)
    init_method = address if '://' in address else f'tcp://{address}'
    processes = int(_from_env('WORLD_SIZE') if num_processes is None else num_processes)
    index = int(_from_env('RANK') if process_id is None else process_id)
    _dist().init_process_group('gloo', init_method=init_method, world_size=processes,
                               rank=index)
    cards = torch.cuda.device_count()
    if cards:
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', index)) % cards)
    return index, processes, processes * min(1, cards)


def collective(fn, *args, **kwargs):
    """Call the cross-process function ``fn`` and count it in
    ``distributed.collective``."""
    count('distributed.collective')
    return fn(*args, **kwargs)


def all_gather(obj, group=None):
    """Every process's ``obj`` (host data, pickled) in rank order, over the
    world or over ``group``: one collective, or none without a group."""
    size = world() if group is None else _dist().get_world_size(group)
    if size == 1:
        return [obj]
    out = [None] * size
    collective(_dist().all_gather_object, out, obj, group=group)
    return out


def new_group(ranks):
    """A process group of ``ranks``: a collective of every process of the
    world, each calling it for every group in the same order."""
    return collective(_dist().new_group, ranks)


def barrier():
    """Wait until every process gets here: one collective, or none without a group."""
    if world() > 1:
        collective(_dist().barrier)
