"""The worm's share of a Villain Hammer fleet step.

PyTorch counterpart of :mod:`supervillain_tpu.benchmark.worm_cost`.  A fleet
step runs the worm of every chain in one call, so it costs the longest worm
over the chains.  At W=1 the close move fires with probability 0.2 each move
(geometric, mean about 5 moves), so the tail is light; at W>1 the worm must
walk its head back to its tail, whose return time on an N × N torus is heavy
tailed (~N² log N), and the longest of B chains can dominate the step.  This
harness measures that share directly: the time of the generic Hammer fleet
step (Site, [Link], Exact, Cohomology, worm) against the same stack without
the worm, and the worm lengths (mean and max over chains × steps).  On the
card the worm is B2 (:func:`..ops.worm.classic_worms`); ``--chunked T``
measures the ChunkedWorm of T micro-moves (PyTorch operations, W=1 only).

Run: ``python -m supervillain_tpu_torch.benchmark.worm_cost --L 64 256 --chains 1024``
on the card, ``--device cpu`` on the host.  What is timed: ``reps`` runs of
``steps`` fleet steps from the cold start, on the host clock around work
that ends in a synchronise, after one synchronised run of warm-up (the
kernels' build and first launches); each printed line names the card and
its power limit.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _synchronize(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _timed_fleet(generator, action, chains, steps, reps=2, seed=0, collect_inline=None,
                 device='cuda'):
    """Seconds per run of ``steps`` steps of ``generator`` over ``chains``
    chains from the cold start (the mean of ``reps`` runs after a warm-up run),
    and the last run's ``collect_inline`` values stacked (steps, chains)."""
    from ..generators.base import per_chain_stats

    device = torch.device(device)
    cfg0 = generator.prepare({k: v.expand((chains,) + v.shape).contiguous()
                              for k, v in action.initial(device).items()})
    stats0 = per_chain_stats(generator.init_stats(), chains, device)

    def run(s):
        g = torch.Generator(device=device).manual_seed(s)
        cfgs, stats, keeps = cfg0, stats0, []
        for _ in range(steps):
            cfgs, stats, inline = generator.step(g, cfgs, stats)
            keeps.append({name: inline[name] for name in collect_inline or ()})
        return keeps

    run(seed)
    _synchronize(device)
    start = time.perf_counter()
    for r in range(reps):
        keeps = run(seed + 1 + r)
    _synchronize(device)
    elapsed = (time.perf_counter() - start) / reps
    stacked = {name: torch.stack([k[name] for k in keeps]).cpu().numpy()
               for name in collect_inline or ()}
    return elapsed, stacked


def worm_share(N, chains, steps=5, kappa=0.5, W=1, seed=0, reps=2, worm_moves=None,
               device='cuda'):
    """Measure the worm's share of a Villain Hammer fleet step at (N, chains)
    on ``device`` (the card unless ``'cpu'``).

    ``worm_moves``: measure the fixed-trip-count :class:`ChunkedWorm` variant
    (W=1 only) instead of the data-dependent-length ClassicWorm."""
    import supervillain_tpu_torch as sv
    from ..generators import villain as gv
    from ..generators.combining import Sequentially

    S = sv.Villain(sv.Lattice2D(N), kappa, W)

    full = gv.Hammer(S, worm_moves=worm_moves)
    parts = [gv.SiteUpdate(S)]
    if S.W < float('inf'):
        parts.append(gv.LinkUpdate(S))
    parts += [gv.ExactUpdate(S), gv.CohomologyUpdate(S)]
    local = Sequentially(parts)

    t_full, keeps = _timed_fleet(full, S, chains, steps, seed=seed, reps=reps,
                                 collect_inline=('Worm_Length',), device=device)
    t_local, _ = _timed_fleet(local, S, chains, steps, seed=seed, reps=reps, device=device)

    wl = keeps['Worm_Length']  # (steps, chains)
    return {
        'N': N, 'chains': chains, 'steps': steps, 'kappa': kappa, 'W': W,
        'worm': 'classic' if worm_moves is None else f'chunked({worm_moves})',
        't_full_s': t_full, 't_local_s': t_local,
        'worm_share': max(0.0, 1.0 - t_local / t_full),
        'worm_length_mean': float(wl.mean()),
        'worm_length_max': float(wl.max()),
    }


def main(argv=None):
    from .scaling import card

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--L', type=int, nargs='+', default=[64, 256])
    ap.add_argument('--chains', type=int, default=1024)
    ap.add_argument('--steps', type=int, default=5)
    ap.add_argument('--kappa', type=float, default=0.5)
    ap.add_argument('--W', type=int, nargs='+', default=[1, 2])
    ap.add_argument('--reps', type=int, default=2)
    ap.add_argument('--chunked', type=int, default=None, metavar='T',
                    help='measure ChunkedWorm(T) instead of ClassicWorm (W=1 only)')
    ap.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    where = card() if torch.device(args.device).type == 'cuda' else 'cpu'
    timed = (f'{args.reps} runs of {args.steps} fleet steps from the cold start, host clock '
             'around work ending in a synchronise, after a synchronised warm-up run')
    for N in args.L:
        for W in args.W:
            if args.chunked is not None and W != 1:
                continue
            res = worm_share(N, args.chains, steps=args.steps, kappa=args.kappa, W=W,
                             reps=args.reps, worm_moves=args.chunked, device=args.device)
            print(json.dumps(res | {'device': where, 'timed': timed}), flush=True)


if __name__ == '__main__':
    main()
