#!/usr/bin/env python
"""Inline worm histogram vs the taxicab reweighting estimator for Spin_Spin: the
inline measurement has far better tails: the port of
``examples/why-measure-inline.py``.

Runs on the card (``--device cuda``, the default: the worm kernel, at any N,
odd or even) or, with ``--device cpu``, through the plain PyTorch versions.
``--figure`` needs matplotlib.
"""

# Allow running this script directly from anywhere: put the repo root (the
# directory containing the supervillain_tpu_torch package) on sys.path.
import pathlib as _pathlib
import sys as _sys
for _p in _pathlib.Path(__file__).resolve().parents:
    if (_p / 'supervillain_tpu_torch').is_dir():
        if str(_p) not in _sys.path:
            _sys.path.insert(0, str(_p))
        break

import numpy as np

import supervillain_tpu_torch as sv
from supervillain_tpu_torch.analysis import Bootstrap, Uncertain
from supervillain_tpu_torch.generators import worldline as gworldline

parser = sv.cli.ArgumentParser(description='Inline vs taxicab Spin_Spin.')
parser.add_argument('--N', type=int, default=7)
parser.add_argument('--kappa', type=float, default=0.5)
parser.add_argument('--W', type=sv.cli.W, default=1)
parser.add_argument('--configurations', type=int, default=5000)
parser.add_argument('--figure', default=False, type=str)
parser.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
args = parser.parse_args()

L = sv.Lattice2D(args.N)
S = sv.Worldline(L, args.kappa, W=args.W)
G = gworldline.Hammer(S)

e = sv.Ensemble(S).generate(args.configurations, G, start='cold',
                            progress=sv.cli.progress, seed=3, device=args.device)
tau = e.autocorrelation_time()
d = e.cut(10 * tau).every(tau)

# Inline: the worm's histogram rode along in the configurations.
b_inline = Bootstrap(d, 200, seed=1)
inline = b_inline.Spin_Spin_Normalized.real

# Taxicab: strip the inline column and re-measure with the reweighting estimator.
d2 = sv.Ensemble(S).from_configurations(d.configuration[:], device=args.device)
del d2.configuration.fields['Spin_Spin']
d2.index, d2.index_stride, d2.weight = d.index, d.index_stride, d.weight
b_taxicab = Bootstrap(d2, 200, seed=1)
taxicab = b_taxicab.Spin_Spin_Normalized.real

print(f'{"Δx":>10s} {"inline":>16s} {"taxicab":>16s} {"ratio of errors":>16s}')
for dx in [(0, 1), (1, 1), (2, 2), (args.N // 2, args.N // 2)]:
    mi, ei = inline.mean(axis=0)[dx], inline.std(axis=0)[dx]
    mt, et = taxicab.mean(axis=0)[dx], taxicab.std(axis=0)[dx]
    print(f'{str(dx):>10s} {str(Uncertain(mi, ei)):>16s} {str(Uncertain(mt, et)):>16s} '
          f'{et / ei if ei > 0 else np.inf:>16.2f}')

if args.figure:
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(1, 1, figsize=(6, 4))
    b_inline.plot_correlator(ax, 'Spin_Spin_Normalized', label='inline (worm)')
    b_taxicab.plot_correlator(ax, 'Spin_Spin_Normalized', offset=0.05, label='taxicab')
    ax.set_yscale('log')
    ax.legend()
    fig.suptitle(f'Worldline N={args.N} κ={args.kappa} W={args.W}')
    fig.savefig(args.figure)
    print(f'wrote {args.figure}')
