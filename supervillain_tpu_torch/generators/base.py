"""Generator protocol and proposal draws.

PyTorch counterpart of :mod:`supervillain_tpu.generators.base`.  A generator
owns static configuration and exposes

    step(generator, cfg, stats) -> (cfg, stats, inline)

where ``generator`` is a ``torch.Generator`` on the device of the fields (the
draws of the plain versions) or on the host (the seeds of the kernels), ``cfg``
the field dict, ``stats`` a dict of acceptance tallies (one sub-dict of Python
floats per generator tag) and ``inline`` a dict of per-step inline observables.
"""

from __future__ import annotations

import torch


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

    def _tally(self, stats, accepted, proposed, acceptance, sweeps=1.0, tag=None):
        tag = tag or self.name
        s = stats[tag]
        return stats | {tag: {
            'accepted': s['accepted'] + float(accepted),
            'proposed': s['proposed'] + float(proposed),
            'acceptance': s['acceptance'] + float(acceptance),
            'sweeps': s['sweeps'] + float(sweeps),
        }}

    def report(self, stats):
        lines = []
        for tag, s in stats.items():
            sweeps = max(s['sweeps'], 1.0)
            if s['proposed'] > 0:
                lines.append(
                    f'{tag}: {s["accepted"]:.0f} proposals accepted of {s["proposed"]:.0f} proposed updates.\n'
                    f'    {s["accepted"] / s["proposed"]:.6f} acceptance rate\n'
                    f'    {s["acceptance"] / sweeps:.6f} average Metropolis acceptance probability.')
            else:
                lines.append(f'{tag}: no proposals recorded.')
        return '\n'.join(lines)
