"""Time the Villain sweep kernel of several checkouts of the PyTorch port on one card.

    python3 tools/compare_villain_sweeps.py DIR [DIR ...]

Each DIR holds a checkout of the port (at least ``supervillain_tpu_torch/``).
The script runs one process per DIR, in the order given (give A B B A so that
a drift of the card's clock cancels), each of which builds that checkout's
kernels, brings a fleet at the main path's shape (L=256, 512 chains, κ=0.5,
W=1) to one state through that checkout's own sweep and worm kernels (six
Hammer calls of 50 sweeps and one worm), and times five 50-sweep calls of
``neighborhood_sweeps`` on fixed seeds with CUDA events, one call at a time.
It prints each call's milliseconds, min / median / max over the five, and the
sweep's device time by kind of launch over three more calls (torch.profiler).
Checkouts whose kernels keep the same draws and arithmetic reach the same
state and the same φ, n and accepted counts: the script fails if those differ.
Whether the inline sums are identical too is printed (their summation order
may differ between kernels).
"""

import hashlib
import json
import re
import statistics
import subprocess
import sys

N, B, KAPPA, W, THIN, SEEDS = 256, 512, 0.5, 1, 50, (11, 12, 13, 14, 15)


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def breakdown(torch, fn, reps):
    """Device milliseconds per call of each kind of launch (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kinds = {}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        found = re.search(r'(\w+)\(', e.key)
        kind = found.group(1) if found else e.key
        count, total = kinds.get(kind, (0, 0.0))
        kinds[kind] = (count + e.count / reps, total + e.self_device_time_total / 1e3 / reps)
    return kinds


def child(checkout):
    sys.path.insert(0, checkout)
    import torch
    from supervillain_tpu_torch.ops.hammer import hammer_sweeps
    from supervillain_tpu_torch.ops.sweep import neighborhood_sweeps

    phi = torch.zeros((B, 1, N, N), dtype=torch.float32, device='cuda')
    n = torch.zeros((B, 2, N, N), dtype=torch.int32, device='cuda')
    g = torch.Generator().manual_seed(1)
    for _ in range(6):
        phi, n, _, _ = hammer_sweeps(phi, n, kappa=KAPPA, W=W, interval_phi=3.141592653589793,
                                     interval_n=1, sweeps=THIN, worms=1,
                                     max_worm_moves=64 * N * N, generator=g)

    def sweep(seed):
        return neighborhood_sweeps(phi, n, kappa=KAPPA, W=W, interval_phi=3.141592653589793,
                                   interval_n=1, sweeps=THIN,
                                   generator=torch.Generator().manual_seed(seed))

    sweep(SEEDS[0])
    calls = []
    for seed in SEEDS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = sweep(seed)
        end.record()
        torch.cuda.synchronize()
        calls.append({'seed': seed, 'ms': start.elapsed_time(end), 'fields': digest(out[:3]),
                      'inline': digest(out[3].values())})
    kinds = breakdown(torch, lambda: sweep(SEEDS[0]), 3)
    print(json.dumps({'state': digest((phi, n)), 'calls': calls, 'kinds': kinds}))


def main(dirs):
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True).stdout.strip()
    print(f'card: {card}')
    runs = []
    for d in dirs:
        p = subprocess.run([sys.executable, __file__, '--child', d], capture_output=True, text=True)
        if p.returncode:
            print(f'{d}: failed ({p.returncode})\n{p.stderr[-4000:]}')
            return 1
        run = json.loads(p.stdout.strip().splitlines()[-1])
        runs.append(run)
        ms = [c['ms'] for c in run['calls']]
        for c in run['calls']:
            print(f"{d} seed {c['seed']}: {c['ms']!r} ms per {THIN}-sweep call")
        print(f'{d}: min / median / max {min(ms)!r} / {statistics.median(ms)!r} / {max(ms)!r} ms '
              f'per call over {len(ms)} calls ({card})')
        total = sum(t for _, t in run['kinds'].values())
        for kind, (count, t) in sorted(run['kinds'].items(), key=lambda kv: -kv[1][1]):
            print(f'  {d} {kind}: {count!r} launches, {t!r} ms per call, {t / total!r} of '
                  f'{total!r} ms of device time (torch.profiler, 3 calls)', flush=True)
    same = len({json.dumps([r['state'], [c['fields'] for c in r['calls']]]) for r in runs}) == 1
    inline = len({json.dumps([c['inline'] for c in r['calls']]) for r in runs}) == 1
    print(f'same state, φ, n and accepted in every checkout: {same}; same inline sums: {inline}')
    return 0 if same else 1


if __name__ == '__main__':
    if sys.argv[1:2] == ['--child']:
        child(sys.argv[2])
    else:
        if len(sys.argv) < 2:
            sys.exit(__doc__)
        sys.exit(main(sys.argv[1:]))
