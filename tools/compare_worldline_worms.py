"""Time the Worldline worm kernel of several checkouts of the PyTorch port on one card.

    python3 tools/compare_worldline_worms.py DIR [DIR ...]

Each DIR holds a checkout of the port (at least ``supervillain_tpu_torch/``).
The script runs one process per DIR, in the order given (give A B B A so that
a drift of the card's clock cancels), each of which builds that checkout's
kernels, brings a fleet at the main path's shape (L=256, 512 chains, κ=0.5,
W=2) to one state through that checkout's own sweep and worm kernels, and
times five worm calls (one worm per chain, capped at 64·N² moves) with CUDA
events.  It prints each call's milliseconds, the moves of its longest worm and
the nanoseconds per move of the longest worm (a worm is a serial walk, so a
call lasts as long as its longest worm), then a line per DIR over the five
calls.  Checkouts whose kernels keep the same draws reach the same state and
the same outputs: the script fails if their digests differ.
"""

import hashlib
import json
import subprocess
import sys

N, B, KAPPA, W, SEEDS = 256, 512, 0.5, 2, (11, 12, 13, 14, 15)


def digest(torch, tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def child(checkout):
    sys.path.insert(0, checkout)
    import torch
    from supervillain_tpu_torch.ops.worldline import worldline_sweeps
    from supervillain_tpu_torch.ops.worldline_worm import worldline_worms

    cap = 64 * N * N
    m = torch.zeros((B, 2, N, N), dtype=torch.int32, device='cuda')
    v = torch.zeros((B, 1, N, N), dtype=torch.int32, device='cuda')
    g = torch.Generator().manual_seed(1)
    for _ in range(6):
        m, v, _, _ = worldline_sweeps(m, v, kappa=KAPPA, W=W, sweeps=50, generator=g)
        m, _, _, _ = worldline_worms(m, v, kappa=KAPPA, W=W, worms=1, max_worm_moves=cap,
                                     generator=g)
    calls = []
    for seed in SEEDS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = worldline_worms(m, v, kappa=KAPPA, W=W, worms=1, max_worm_moves=cap,
                              generator=torch.Generator().manual_seed(seed))
        end.record()
        torch.cuda.synchronize()
        calls.append({'seed': seed, 'ms': start.elapsed_time(end),
                      'longest': float(out[2].max()), 'digest': digest(torch, out)})
    print(json.dumps({'state': digest(torch, (m, v)), 'calls': calls}))


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
        for c in run['calls']:
            print(f"{d} seed {c['seed']}: {c['ms']!r} ms, longest worm {c['longest']!r} moves, "
                  f"{c['ms'] * 1e6 / c['longest']!r} ns per move of the longest worm")
        ms = sum(c['ms'] for c in run['calls'])
        longest = sum(c['longest'] for c in run['calls'])
        print(f'{d}: {ms!r} ms over {len(SEEDS)} calls, {ms * 1e6 / longest!r} ns per move of '
              f'the longest worm ({card})', flush=True)
    same = len({json.dumps([r['state'], [c['digest'] for c in r['calls']]]) for r in runs}) == 1
    print(f'same state and outputs in every checkout: {same}')
    return 0 if same else 1


if __name__ == '__main__':
    if sys.argv[1:2] == ['--child']:
        child(sys.argv[2])
    else:
        if len(sys.argv) < 2:
            sys.exit(__doc__)
        sys.exit(main(sys.argv[1:]))
