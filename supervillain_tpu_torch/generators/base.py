"""Generator protocol and proposal draws.

PyTorch counterpart of :mod:`supervillain_tpu.generators.base`.  A generator
owns static configuration and exposes

    step(generator, cfg, stats) -> (cfg, stats, inline)

where ``generator`` is a ``torch.Generator`` on the device of the fields (the
draws of the plain PyTorch updates, and the seeds of the kernels), ``cfg`` the
field dict of a batch of independent chains (every field has a leading chain
axis: B chains in a fleet, one under :meth:`Ensemble.generate`), ``stats`` a
dict of acceptance tallies summed over the chains (one sub-dict per generator
tag; the values stay on the fields' device until :func:`host_stats` reads
them) and ``inline`` a dict of per-step inline observables, one per chain.
"""

from __future__ import annotations

import torch

from ..device import float_dtype_of


def uniform_nonzero_int(generator, shape, interval, dtype=torch.int64, device='cpu'):
    """Uniform over ±{1, ..., interval} (zero excluded)."""
    r = torch.randint(0, 2 * interval, shape, generator=generator, dtype=dtype, device=device)
    return torch.where(r < interval, r - interval, r - interval + 1)


def uniform_int_with_zero(generator, shape, interval, dtype=torch.int64, device='cpu'):
    """Uniform over {-interval, ..., +interval} (zero included)."""
    return torch.randint(-interval, interval + 1, shape, generator=generator,
                         dtype=dtype, device=device)


def zero_inflated_int(generator, shape, interval, p, dtype=torch.int64, device='cpu'):
    """Symmetric sparse proposal: ±k with k uniform in {1..interval}, each sign with
    probability p/2; zero otherwise.  P(+k) = P(−k), so a Metropolis update built on
    it satisfies detailed balance."""
    u = torch.rand(shape, generator=generator, device=device)
    mag = torch.randint(1, interval + 1, shape, generator=generator, dtype=dtype, device=device)
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


def host_stats(stats):
    """The tallies as Python floats (one read of each device value)."""
    return {tag: {k: float(v) for k, v in s.items()} for tag, s in stats.items()}


def _total(value, chains):
    """A per-chain tally summed over the batch: a (B,) tensor in float64 on its
    device, or a number that every chain adds."""
    if isinstance(value, torch.Tensor):
        return value.sum(dtype=torch.float64)
    return float(value) * chains


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
            'accepted': s['accepted'] + _total(accepted, chains),
            'proposed': s['proposed'] + _total(proposed, chains),
            'acceptance': s['acceptance'] + _total(acceptance, chains),
            'sweeps': s['sweeps'] + _total(sweeps, chains),
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
