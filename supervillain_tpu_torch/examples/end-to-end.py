#!/usr/bin/env python
"""Smoke workload: a 5×5 Villain chain with NeighborhoodUpdate (or a Worldline chain
with Plaquette+Wrapping), measure → autocorrelation → cut/every → bootstrap: the
port of ``examples/end-to-end.py``.

Runs on the card (``--device cuda``, the default; the neighborhood update
launches the sweep kernel, at any N: the default N=5 through its four-color
table) or, with ``--device cpu``, through the plain PyTorch versions.  ``--figure`` needs matplotlib, and the
progress bar shows where tqdm imports.
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

import supervillain_tpu_torch as sv
from supervillain_tpu_torch.analysis import Bootstrap, Uncertain
from supervillain_tpu_torch.generators import villain as gvillain, worldline as gworldline
from supervillain_tpu_torch.generators import Sequentially

parser = sv.cli.ArgumentParser(description='End-to-end smoke workload.')
parser.add_argument('--action', choices=('villain', 'worldline'), default='villain')
parser.add_argument('--N', type=int, default=5)
parser.add_argument('--kappa', type=float, default=0.5)
parser.add_argument('--W', type=sv.cli.W, default=1)
parser.add_argument('--configurations', type=int, default=10000)
parser.add_argument('--figure', default=False, type=str)
parser.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
args = parser.parse_args()

L = sv.Lattice2D(args.N)
if args.action == 'villain':
    S = sv.Villain(L, args.kappa, W=args.W)
    # At W=∞ the neighborhood proposal (Δn in multiples of W) is undefined;
    # the exact-sector twin proposes (Δφ, Δz) with Δn = d(Δz) instead.
    if args.W == float('inf'):
        G = gvillain.ExactNeighborhoodUpdate(S)
    else:
        G = gvillain.NeighborhoodUpdate(S)
else:
    S = sv.Worldline(L, args.kappa, W=args.W)
    G = Sequentially((gworldline.PlaquetteUpdate(S), gworldline.WrappingUpdate(S)))

e = sv.Ensemble(S).generate(args.configurations, G, start='cold', progress=sv.cli.progress,
                            seed=5, device=args.device)
print(G.report(e.stats))

e.measure(('ActionDensity', 'InternalEnergyDensity', 'WindingSquared'))
tau = e.autocorrelation_time()
print(f'autocorrelation time {tau}')

d = e.cut(5 * tau).every(tau)
b = Bootstrap(d, 100)
for o in ('ActionDensity', 'InternalEnergyDensity', 'WindingSquared'):
    print(f'{o:32s} {Uncertain(*b.estimate(o))}')

if args.figure:
    import matplotlib
    matplotlib.use('Agg')
    from supervillain_tpu_torch.analysis import comparison_plot
    obs = ('ActionDensity', 'InternalEnergyDensity', 'WindingSquared')
    fig, ax = comparison_plot.setup(obs)
    comparison_plot.bootstraps(ax, (b,), (args.action,), observables=obs)
    comparison_plot.histories(ax, (e,), (args.action,), observables=obs)
    fig.tight_layout()
    fig.savefig(args.figure)
    print(f'wrote {args.figure}')
