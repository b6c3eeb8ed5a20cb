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


def _rows(values, cut):
    return values if cut is None else values.narrow(*cut)


def rand(generator, shape, *, dtype=None, device, axis=0):
    """``torch.rand(shape)`` of the chains of ``generator``'s batch, the chain
    axis being ``axis`` of ``shape``."""
    full, cut = _fleet(generator, shape, axis)
    return _rows(torch.rand(full, generator=torch_generator(generator), dtype=dtype,
                            device=device), cut)


def randint(generator, low, high, shape, *, dtype=torch.int64, device, axis=0):
    """``torch.randint(low, high, shape)`` of the chains of ``generator``'s
    batch, the chain axis being ``axis`` of ``shape``."""
    full, cut = _fleet(generator, shape, axis)
    return _rows(torch.randint(low, high, full, generator=torch_generator(generator),
                               dtype=dtype, device=device), cut)
