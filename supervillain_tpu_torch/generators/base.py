"""Generator protocol and proposal draws.

PyTorch counterpart of :mod:`supervillain_tpu.generators.base`.  A generator
owns static configuration and exposes

    step(generator, cfg, stats) -> (cfg, stats, inline)

where ``generator`` is a ``torch.Generator`` on the device of the fields (the
draws of the plain PyTorch updates, and the seeds of the kernels), or a
shard's :class:`..ops.shard.ShardGenerator` in a fleet cut into shards,
``cfg`` the field dict of a batch of independent chains (every field has a
leading chain axis: B chains in a fleet, one under :meth:`Ensemble.generate`),
``stats`` a dict of acceptance tallies (one sub-dict per generator tag; the
values stay on the fields' device until :func:`host_stats` reads them) and
``inline`` a dict of per-step inline observables, one per chain.  The
tallies are summed over the chains, or kept per chain where they start as
:func:`per_chain_stats` (a fleet's, which sums them once at its end).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import float_dtype_of
from ..ops import shard


def uniform_nonzero_int(generator, shape, interval, dtype=torch.int64, device='cpu'):
    """Uniform over ±{1, ..., interval} (zero excluded).  ``shape`` leads with
    the chain axis, here and in the draws below (a shard of a fleet keeps its
    rows of the fleet's draw: :mod:`..ops.shard`)."""
    r = shard.randint(generator, 0, 2 * interval, shape, dtype=dtype, device=device)
    return torch.where(r < interval, r - interval, r - interval + 1)


def uniform_int_with_zero(generator, shape, interval, dtype=torch.int64, device='cpu'):
    """Uniform over {-interval, ..., +interval} (zero included)."""
    return shard.randint(generator, -interval, interval + 1, shape, dtype=dtype, device=device)


def zero_inflated_int(generator, shape, interval, p, dtype=torch.int64, device='cpu'):
    """Symmetric sparse proposal: ±k with k uniform in {1..interval}, each sign with
    probability p/2; zero otherwise.  P(+k) = P(−k), so a Metropolis update built on
    it satisfies detailed balance."""
    u = shard.rand(generator, shape, device=device)
    mag = shard.randint(generator, 1, interval + 1, shape, dtype=dtype, device=device)
    sign = (u < p / 2).to(dtype) - ((u >= p / 2) & (u < p)).to(dtype)
    return sign * mag


def metropolis(u, dS):
    """Metropolis test of uniform draws ``u`` against ``ΔS``: the accept mask and
    the clipped acceptance probability."""
    acceptance = torch.clamp(torch.exp(-dS), max=1.0)
    return u < acceptance, acceptance


def empty_stats():
    """One generator tag's zeroed acceptance tallies."""
    return {'accepted': 0.0, 'proposed': 0.0, 'acceptance': 0.0, 'sweeps': 0.0}


def per_chain_stats(stats, chains, device):
    """``stats`` (as :meth:`Generator.init_stats` gives them) kept per chain:
    each tally a (chains,) float64 tensor on ``device``."""
    return {tag: {k: torch.full((chains,), float(v), dtype=torch.float64, device=device)
                  for k, v in s.items()} for tag, s in stats.items()}


def _chain_sum(value):
    """A tally as a Python float: a per-chain one summed with ``math.fsum``,
    whose correctly rounded sum does not depend on the chains' order, so a
    fleet's stats come out the same however its chains were split."""
    if isinstance(value, torch.Tensor):
        value = value.cpu().numpy()
    if np.ndim(value) == 1:
        return math.fsum(value)
    return float(value)


def host_stats(stats):
    """The tallies as Python floats, summed over the chains where they are
    kept per chain (one read of each device value)."""
    return {tag: {k: _chain_sum(v) for k, v in s.items()} for tag, s in stats.items()}


def _add(total, value, chains):
    """Add a step's per-chain tally ``value`` (a (B,) tensor, or a number that
    every chain adds) to a running ``total``: chain by chain where the total is
    kept per chain, else summed over the batch in float64."""
    if isinstance(total, torch.Tensor) and total.dim() == 1:
        return total + (value.to(torch.float64) if isinstance(value, torch.Tensor)
                        else float(value))
    if isinstance(value, torch.Tensor):
        return total + value.sum(dtype=torch.float64)
    return total + float(value) * chains


class Generator:
    """Base class: stats bookkeeping."""

    #: Identifier used as the stats key; overridden per class.
    name = 'Generator'

    def __str__(self):
        return self.name

    def init_stats(self):
        return {self.name: empty_stats()}

    def inline_shapes(self):
        """dict name -> shape of per-step inline observables."""
        return {}

    def step(self, generator, cfg, stats):  # pragma: no cover - abstract
        raise NotImplementedError

    def prepare(self, cfg):
        """Add any generator-carried state to a starting batch of chains
        (:class:`~.villain.ChunkedWorm` carries its open worm).  Default: none."""
        return cfg

    def _tally(self, stats, chains, accepted, proposed, acceptance, sweeps=1.0, tag=None):
        """Add one step of ``chains`` chains to ``stats[tag]``: each value is
        per chain, a (B,) tensor or a number every chain shares."""
        tag = tag or self.name
        s = stats[tag]
        return stats | {tag: {
            'accepted': _add(s['accepted'], accepted, chains),
            'proposed': _add(s['proposed'], proposed, chains),
            'acceptance': _add(s['acceptance'], acceptance, chains),
            'sweeps': _add(s['sweeps'], sweeps, chains),
        }}

    def report(self, stats):
        lines = []
        for tag, s in host_stats(stats).items():
            sweeps = max(s['sweeps'], 1.0)
            if s['proposed'] > 0:
                lines.append(
                    f'{tag}: {s["accepted"]:.0f} proposals accepted of {s["proposed"]:.0f} proposed updates.\n'
                    f'    {s["accepted"] / s["proposed"]:.6f} acceptance rate\n'
                    f'    {s["acceptance"] / sweeps:.6f} average Metropolis acceptance probability.')
            else:
                lines.append(f'{tag}: no proposals recorded.')
        return '\n'.join(lines)


class PassUpdate(Generator):
    """A local update made of passes: a checkerboard color each, or one over
    every link.  A pass reads a site's or a link's fields and those of its
    nearest neighbours only, so a chain × space mesh
    (:mod:`..parallel.space`) runs each pass on every slab of a chain, with a
    halo exchange of the state before it, and then this code unchanged.

    ``begin`` makes the state (the fields and what the passes carry between
    them), ``run_pass`` runs one pass of :meth:`pass_keys` and returns the
    state and the pass's accepted count and acceptance sum per chain, over the
    sites the batch owns (:func:`..ops.shard.site_sum`), ``finish`` puts the
    state's fields back into the configuration, and ``tally`` adds the step's
    totals to the stats."""

    def begin(self, generator, cfg):  # pragma: no cover - abstract
        raise NotImplementedError

    def pass_keys(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def run_pass(self, generator, state, key):  # pragma: no cover - abstract
        raise NotImplementedError

    def finish(self, cfg, state):
        return cfg | {k: state[k] for k in self.fields}

    def tally(self, stats, chains, accepted, acceptance):  # pragma: no cover - abstract
        raise NotImplementedError

    def step(self, generator, cfg, stats):
        state = self.begin(generator, cfg)
        accepted = acceptance = 0
        for key in self.pass_keys():
            state, a, p = self.run_pass(generator, state, key)
            accepted, acceptance = accepted + a, acceptance + p
        chains = state[self.fields[0]].shape[0]
        return self.finish(cfg, state), self.tally(stats, chains, accepted, acceptance), {}


class DoNothing(Generator):
    """Identity update with a constant inline observable ``one``."""

    name = 'DoNothing'

    def inline_shapes(self):
        return {'one': ()}

    def step(self, generator, cfg, stats):
        field = next(iter(cfg.values()))
        chains = field.shape[0]
        one = torch.ones(chains, dtype=float_dtype_of(field), device=field.device)
        return cfg, self._tally(stats, chains, 0.0, 0.0, 0.0), {'one': one}
