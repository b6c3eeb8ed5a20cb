"""The chain mesh: the devices a fleet's chains run on.

PyTorch counterpart of the ``chains`` axis of
:mod:`supervillain_tpu.parallel.mesh`.  Chains are independent Markov chains:
a fleet cut into contiguous blocks of chains, one block a shard, runs each
shard on its device with no communication inside a record, and gathers the
records once at the end of a run (:mod:`.fleet`, :mod:`.fused_fleet`).  A
chain's draws depend only on the seed and its global index
(:mod:`..ops.shard`), so the result does not depend on the layout.

Across processes (:mod:`.distributed`) every process lists its own devices,
as many in each, and process r holds the shards r·len(devices) onward.
"""

from __future__ import annotations

import torch

from . import distributed


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def device_kind(device) -> str:
    """The name of the device's hardware: the card's, or ``'cpu'``."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == 'cuda' else device.type


class ChainMesh:
    """The shards of a chain mesh: ``devices``, this process's in order, and as
    many in each of the group's ``world`` processes.  A device may be listed
    more than once; its shards then run in turn on it (a check of the
    plumbing, not scaling).  ``size`` counts the shards of all processes."""

    def __init__(self, devices, rank=0, world=1):
        self.devices = tuple(_device(d) for d in devices)
        if not self.devices:
            raise ValueError('a chain mesh needs at least one device')
        self.rank, self.world = int(rank), int(world)

    @property
    def size(self) -> int:
        return len(self.devices) * self.world

    def shards(self, chains):
        """(device, block of global chain indices) of each of this process's shards."""
        blocks = fleet_sharding(self, chains)
        first = self.rank * len(self.devices)
        return [(d, blocks[first + i]) for i, d in enumerate(self.devices)]

    def kinds(self):
        """The hardware of this process's shards, in order."""
        return [device_kind(d) for d in self.devices]

    def __repr__(self):
        return f'ChainMesh({[str(d) for d in self.devices]}, rank={self.rank}, world={self.world})'


def chain_mesh(devices=None):
    """A 1-D mesh over ``devices``, by default every card: all that
    ``torch.cuda.device_count()`` reports, or, in a group of processes, this
    process's card, so that the mesh covers every card of every process."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("chain_mesh() covers the CUDA cards and none is available; "
                               "pass the devices, e.g. chain_mesh(['cpu'])")
        if distributed.world() > 1:
            devices = [torch.device('cuda', torch.cuda.current_device())]
        else:
            devices = [torch.device('cuda', i) for i in range(torch.cuda.device_count())]
    return ChainMesh(devices, distributed.rank(), distributed.world())


def fleet_sharding(mesh, chains):
    """The contiguous block of global chain indices of each shard of ``mesh``,
    in order: ``chains // mesh.size`` each, one more for the first
    ``chains % mesh.size`` shards."""
    base, extra = divmod(int(chains), mesh.size)
    blocks, start = [], 0
    for k in range(mesh.size):
        count = base + (k < extra)
        blocks.append(range(start, start + count))
        start += count
    return blocks
