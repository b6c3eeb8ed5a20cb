"""The chain mesh and the chain × space mesh: the devices a fleet runs on.

PyTorch counterpart of :mod:`supervillain_tpu.parallel.mesh`: the ``chains``
axis (:class:`ChainMesh`) and the ``space`` axis beside it
(:class:`ChainSpaceMesh`, which :mod:`.space` runs).  Chains are independent
Markov chains: a fleet cut into contiguous blocks of chains, one block a
shard, runs each shard on its device with no communication inside a record,
and gathers the records once at the end of a run (:mod:`.fleet`,
:mod:`.fused_fleet`).  A
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


class ChainSpaceMesh(ChainMesh):
    """A 2-D mesh ``(chains, space)``: data-parallel chains × the lattice's
    last axis cut into ``space`` contiguous slabs, a slab a shard.  Shard f
    of the mesh, in row-major order, is row ``f // space`` (a block of chains)
    and slab ``f % space``; process r holds the shards r·len(devices) onward.
    A device may be listed more than once, as in a :class:`ChainMesh`.  A row
    whose slabs lie in more than one process talks through a process group of
    its own (:mod:`.distributed`), made here, by every process alike."""

    axis_names = ('chains', 'space')

    def __init__(self, devices, chains, space, rank=0, world=1):
        super().__init__(devices, rank, world)
        self.chains_axis, self.space = int(chains), int(space)
        if self.chains_axis < 1 or self.space < 1:
            raise ValueError(f'a chain × space mesh needs chains, space >= 1, got '
                             f'{chains} × {space}')
        if self.chains_axis * self.space != self.size:
            raise ValueError(f'chains*space = {self.chains_axis * self.space} != {self.size} '
                             'devices')
        self.groups = [self._group(row) for row in range(self.chains_axis)]

    def _group(self, row):
        if self.world == 1:
            return None
        per = len(self.devices)
        processes = sorted({f // per for f in range(row * self.space, (row + 1) * self.space)})
        group = distributed.new_group(processes)
        return group if len(processes) > 1 and self.rank in processes else None

    def places(self):
        """(row, slab) of each of this process's shards, in order."""
        first = self.rank * len(self.devices)
        return [divmod(first + i, self.space) for i in range(len(self.devices))]

    def __repr__(self):
        return (f'ChainSpaceMesh({[str(d) for d in self.devices]}, chains={self.chains_axis}, '
                f'space={self.space}, rank={self.rank}, world={self.world})')


def chain_space_mesh(chains, space, devices=None):
    """A 2-D mesh ``(chains, space)`` over ``devices`` (by default as
    :func:`chain_mesh` takes them: every card, or in a group of processes
    this process's card), which must number ``chains·space`` over all
    processes."""
    mesh = chain_mesh(devices)
    return ChainSpaceMesh(mesh.devices, chains, space, mesh.rank, mesh.world)


def slab_width(N, space):
    """The width of each of ``space`` slabs of a torus of side ``N``: N is
    refused unless it splits into slabs of even width, so that every slab
    starts on an even column and the two colors of the torus keep their
    parity on it."""
    N, space = int(N), int(space)
    if space < 1 or N % space or (N // space) % 2:
        raise ValueError(f'N={N} does not split into {space} slabs of even width: the space '
                         f'axis needs N divisible by 2·space')
    return N // space


def fleet_sharding(mesh, chains, spatial=False, N=None):
    """The contiguous block of global chain indices of each shard of ``mesh``,
    in order: the rows of a chain × space mesh (each shard of a row holds its
    block) or the shards of a chain mesh each take ``chains // rows``, one
    more for the first ``chains % rows``.  With ``spatial`` and a mesh with a
    ``space`` axis, each shard's (block, columns) of a torus of side ``N``:
    its slab's contiguous columns of the last axis."""
    space = getattr(mesh, 'space', 1)
    rows = mesh.size // space
    base, extra = divmod(int(chains), rows)
    row_blocks, start = [], 0
    for k in range(rows):
        count = base + (k < extra)
        row_blocks.append(range(start, start + count))
        start += count
    blocks = [row_blocks[f // space] for f in range(mesh.size)]
    if not spatial or space == 1:
        return blocks
    width = slab_width(N, space)
    return [(block, range((f % space) * width, (f % space + 1) * width))
            for f, block in enumerate(blocks)]
