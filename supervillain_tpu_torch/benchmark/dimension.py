"""Steady-state D ≥ 3 throughput: site-updates/s against the chain count.

Counterpart of :mod:`supervillain_tpu.benchmark.dimension`.  No hand kernel
exists at D ≥ 3 (the TPU kernels are D=2 only), so the eager
:class:`~..generators.villain.NeighborhoodUpdate` runs there as PyTorch
operations: per color pass some 8D + 10 whole-lattice operations (proposals,
ΔS per direction, the accept mask, the applied fields), each a launch on the
card.  At 8⁴ a chain is 100 kB, so a small batch is bound by the launches and
a large one by the bytes those operations move; the curve shows where the
batch leaves the first regime.

Run: ``python -m supervillain_tpu_torch.benchmark.dimension`` (the card; pass
``--device cpu`` to time the host instead).  Every rate is the device's own:
the timed region ends in a synchronise.
"""

from __future__ import annotations

import time

import torch


def steady_state_rate(D=4, N=8, chains=256, thin=16, reps=3, kappa=0.4, W=1, seed=0,
                      device='cuda'):
    """Site-updates/s of ``chains`` chains of the eager NeighborhoodUpdate,
    after one untimed call of ``thin`` steps (warm-up and the first
    thermalization): ``reps`` calls of ``thin`` steps each, timed on the host
    clock around work that ends in a synchronise.  Returns (rate, seconds)."""
    import supervillain_tpu_torch as sv
    from supervillain_tpu_torch.device import resolve_device
    from supervillain_tpu_torch.generators import villain as gv

    device = resolve_device(device)
    S = sv.Villain(sv.Lattice(D, N), kappa, W=W)
    G = gv.NeighborhoodUpdate(S)
    cold = S.initial(device)
    cfg = {k: v.expand((chains,) + v.shape).contiguous() for k, v in cold.items()}
    rng = torch.Generator(device=device).manual_seed(seed)

    def advance(cfg):
        stats = G.init_stats()
        for _ in range(thin):
            cfg, stats, _ = G.step(rng, cfg, stats)
        return cfg

    def synchronise():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    cfg = advance(cfg)
    synchronise()
    start = time.perf_counter()
    for _ in range(reps):
        cfg = advance(cfg)
    synchronise()
    elapsed = time.perf_counter() - start
    return reps * chains * N ** D * thin / elapsed, elapsed


def saturation_curve(D=4, N=8, chain_counts=(32, 128, 512, 2048, 8192), thin=16, reps=3,
                     kappa=0.4, W=1, samples=3, device='cuda'):
    """The median steady-state site-updates/s of ``samples`` seeds for each
    chain count, stopping once a count gains no more than 5% on the last (the
    knee of the curve)."""
    curve = {}
    prev = None
    for B in chain_counts:
        rates = sorted(steady_state_rate(D=D, N=N, chains=B, thin=thin, reps=reps, kappa=kappa,
                                         W=W, seed=s, device=device)[0]
                       for s in range(samples))
        r = rates[samples // 2]
        curve[f'chains={B}'] = r
        print(f'D={D} N={N} chains={B:>6}: {r:.3e} su/s', flush=True)
        if prev is not None and r < prev * 1.05:
            break
        prev = r
    return curve


if __name__ == '__main__':
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument('--D', type=int, default=4)
    ap.add_argument('--N', type=int, default=8)
    ap.add_argument('--thin', type=int, default=16)
    ap.add_argument('--kappa', type=float, default=0.4)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--json', type=str, default=None)
    args = ap.parse_args()

    curve = saturation_curve(D=args.D, N=args.N, thin=args.thin, kappa=args.kappa,
                             device=args.device)
    name = (torch.cuda.get_device_name(0) if torch.device(args.device).type == 'cuda'
            else 'cpu')
    payload = {'config': vars(args), 'steady_state_su_per_s': curve, 'device': name}
    print(json.dumps(payload))
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(payload, f, indent=1)
