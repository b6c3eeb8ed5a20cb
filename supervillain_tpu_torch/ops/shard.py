"""A batch of chains as a shard of a fleet, and the draws it makes.

A fleet cut into shards (:mod:`..parallel.mesh`) must give every chain what
it gets when the fleet runs whole.  Every step draws its randomness from a
``torch.Generator``; in place of one, a shard hands its steps a
:class:`ShardGenerator`, which knows where the shard's chains sit in the fleet.
Through :func:`rand` and :func:`randint`, the one place that reads it, each
draw is made for the whole fleet and the shard keeps its chains' rows along the
draw's chain axis.  So a shard's chains draw what they draw unsharded, and
every shard's generator, seeded alike, stays in step with the others.  The
CUDA kernels count their Philox streams by the global chain index instead: a
shard passes its first chain's index, :func:`chain0_of`, as their ``chain0``.

A chain × space mesh (:mod:`..parallel.space`) also cuts each chain's
lattice along its last axis into slabs, each held with ``ghost`` columns of
its neighbours on either side.  A slab's steps draw from a
:class:`SlabGenerator`: each draw over the lattice is made for the whole fleet
and the whole torus, and the slab keeps its chains' rows and its columns, the
ghosts included, so that every site draws what it draws unsharded.  Its
:func:`mask` is the torus's checkerboard color on those columns, and
:func:`site_sum` sums a site or link quantity over the slab's own columns.

A plain ``torch.Generator`` is a fleet of its own batch: the helpers then draw
exactly what ``torch.rand`` and ``torch.randint`` draw.
"""

from __future__ import annotations

import torch


class ShardGenerator:
    """Chains ``[chain0, chain0 + B)`` of a fleet of ``chains`` chains, drawing
    from ``generator``.  Every shard of one fleet holds a generator seeded
    alike (on its own device), so that each draws the same numbers."""

    def __init__(self, generator: torch.Generator, chain0: int, chains: int):
        if not 0 <= chain0 <= chains:
            raise ValueError(f'chain0={chain0} lies outside a fleet of {chains} chains')
        self.generator, self.chain0, self.chains = generator, int(chain0), int(chains)

    @property
    def device(self):
        return self.generator.device


class Slab:
    """Columns ``[col0, col0 + width)`` of a torus of side ``N`` along its last
    axis, held with ``ghost`` columns of the neighbouring slabs on either side:
    padded column j is global column ``(col0 - ghost + j) mod N``."""

    def __init__(self, N: int, col0: int, width: int, ghost: int):
        if not (0 <= col0 < N and 0 < width <= N and 0 <= ghost <= width):
            raise ValueError(f'no slab of {width} columns from {col0} with {ghost} ghosts '
                             f'on a torus of {N}')
        self.N, self.col0, self.width, self.ghost = int(N), int(col0), int(width), int(ghost)
        self._columns = {}

    @property
    def padded(self) -> int:
        """The slab's columns with its ghosts."""
        return self.width + 2 * self.ghost

    @property
    def first(self) -> int:
        """The global column of padded column 0."""
        return (self.col0 - self.ghost) % self.N

    def columns(self, device) -> torch.Tensor:
        """The global column of each padded column, on ``device``."""
        device = torch.device(device)
        if device not in self._columns:
            self._columns[device] = torch.remainder(
                torch.arange(self.padded, device=device) + self.first, self.N)
        return self._columns[device]

    def cut(self, values):
        """``values`` over the whole torus's last axis, cut to the padded slab."""
        if values.shape[-1] != self.N:
            raise ValueError(f'a slab cuts a last axis of {self.N}, not {values.shape[-1]}')
        return values.index_select(-1, self.columns(values.device))

    def own(self, values):
        """The slab's own columns of a padded ``values``."""
        return values[..., self.ghost:self.ghost + self.width]

    def mask(self, L, color, device):
        """Checkerboard color ``color`` of the torus on the padded slab's sites."""
        return self.cut(L.mask(color, device))

    def site_sum(self, values, D):
        """Σ of ``values`` over the last D axes, the slab's own columns of the last."""
        return self.own(values).sum(dim=tuple(range(-D, 0)))

    def __repr__(self):
        return (f'Slab(N={self.N}, col0={self.col0}, width={self.width}, '
                f'ghost={self.ghost})')


class SlabGenerator(ShardGenerator):
    """A :class:`ShardGenerator` of a slab: chains ``[chain0, chain0 + B)`` of
    a fleet of ``chains``, on the columns of ``slab``."""

    def __init__(self, generator: torch.Generator, chain0: int, chains: int, slab: Slab):
        super().__init__(generator, chain0, chains)
        self.slab = slab

    def chains_view(self) -> ShardGenerator:
        """The same stream as a shard of whole chains (a step run on the
        gathered chain draws through it)."""
        return ShardGenerator(self.generator, self.chain0, self.chains)


def slab_of(generator):
    """The :class:`Slab` a generator's batch holds, or None for whole chains."""
    return generator.slab if isinstance(generator, SlabGenerator) else None


def mask(generator, L, color, device):
    """Checkerboard color ``color`` of ``L`` on the sites of ``generator``'s batch."""
    slab = slab_of(generator)
    return L.mask(color, device) if slab is None else slab.mask(L, color, device)


def site_sum(generator, values, D):
    """Σ over the last D axes of ``values`` (the sites, or a form's components
    and sites), over the sites that ``generator``'s batch owns: all of them,
    or a slab's own columns."""
    slab = slab_of(generator)
    return values.sum(dim=tuple(range(-D, 0))) if slab is None else slab.site_sum(values, D)


def torch_generator(generator) -> torch.Generator:
    """The ``torch.Generator`` a step draws from."""
    return generator.generator if isinstance(generator, ShardGenerator) else generator


def chain0_of(generator) -> int:
    """The global index of the first chain of the batch that draws from ``generator``."""
    return generator.chain0 if isinstance(generator, ShardGenerator) else 0


def resolve_chain0(generator, chain0, device) -> int:
    """A kernel entry point's ``chain0``: the generator's own when None.  On
    the CPU the draws come from the generator, so another ``chain0`` raises."""
    own = chain0_of(generator)
    if chain0 is None:
        return own
    if int(chain0) != own and torch.device(device).type == 'cpu':
        raise ValueError(f'a CPU batch draws from its generator, whose first chain is {own}, '
                         f'not chain0={chain0}: pass the shard as a ShardGenerator')
    return int(chain0)


def _fleet(generator, shape, axis):
    """The shape of the whole fleet's draw, and how to cut the shard's rows from it."""
    if not isinstance(generator, ShardGenerator):
        return tuple(shape), None
    shape = list(shape)
    B = shape[axis]
    if generator.chain0 + B > generator.chains:
        raise ValueError(f'{B} chains from chain0={generator.chain0} exceed the fleet\'s '
                         f'{generator.chains}')
    shape[axis] = generator.chains
    return tuple(shape), (axis, generator.chain0, B)


def _torus(generator, shape):
    """A slab's draw is made over the whole torus: its last axis, the torus's
    side or the padded slab's width, becomes the side."""
    slab = slab_of(generator)
    if slab is None:
        return tuple(shape)
    if not shape or shape[-1] not in (slab.N, slab.padded):
        raise ValueError(f'a slab draws over the lattice\'s last axis ({slab.N} or '
                         f'{slab.padded} columns), not a shape {tuple(shape)}: draw '
                         'through chains_view()')
    return tuple(shape[:-1]) + (slab.N,)


def _rows(values, cut, generator):
    values = values if cut is None else values.narrow(*cut)
    slab = slab_of(generator)
    return values if slab is None else slab.cut(values)


def rand(generator, shape, *, dtype=None, device, axis=0):
    """``torch.rand(shape)`` of the chains of ``generator``'s batch, the chain
    axis being ``axis`` of ``shape`` (and of a slab's, its columns)."""
    full, cut = _fleet(generator, _torus(generator, shape), axis)
    return _rows(torch.rand(full, generator=torch_generator(generator), dtype=dtype,
                            device=device), cut, generator)


def randint(generator, low, high, shape, *, dtype=torch.int64, device, axis=0):
    """``torch.randint(low, high, shape)`` of the chains of ``generator``'s
    batch, the chain axis being ``axis`` of ``shape`` (and of a slab's, its
    columns)."""
    full, cut = _fleet(generator, _torus(generator, shape), axis)
    return _rows(torch.randint(low, high, full, generator=torch_generator(generator),
                               dtype=dtype, device=device), cut, generator)
