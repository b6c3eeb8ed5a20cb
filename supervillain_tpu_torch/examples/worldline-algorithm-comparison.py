#!/usr/bin/env python
"""Local-update stack vs +Worm for the Worldline action: same observables, shorter
autocorrelation time: the port of ``examples/worldline-algorithm-comparison.py``.

Runs on the card (``--device cuda``, the default: the worm kernel, at any N,
odd or even) or, with ``--device cpu``, through the plain PyTorch versions.
``--figure`` needs matplotlib.  ``pulls`` holds the pull of each observable.
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
from supervillain_tpu_torch.analysis import Uncertain, Bootstrap
from supervillain_tpu_torch.generators import worldline as gworldline
from supervillain_tpu_torch.generators import Sequentially

parser = sv.cli.ArgumentParser(description='Worldline local updates vs +worm.')
parser.add_argument('--D', type=int, default=2)
parser.add_argument('--N', type=int, default=5)
parser.add_argument('--kappa', type=float, default=0.5)
parser.add_argument('--W', type=sv.cli.W, default=1)
parser.add_argument('--configurations', type=int, default=10000)
parser.add_argument('--figure', default=False, type=str)
parser.add_argument('--observables', nargs='*',
                    default=('ActionDensity', 'InternalEnergyDensity',
                             'InternalEnergyDensitySquared', 'WindingSquared',
                             'WrappingSquared'))
parser.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
args = parser.parse_args()

L = sv.Lattice(args.D, args.N)
S = sv.Worldline(L, args.kappa, W=args.W)

local = Sequentially((
    gworldline.PlaquetteUpdate(S),
    gworldline.VortexUpdate(S),
    gworldline.CoexactUpdate(S),
    gworldline.WrappingUpdate(S),
))
n = sv.Ensemble(S).generate(args.configurations, local, start='cold',
                            progress=sv.cli.progress, seed=1, device=args.device)
print(local.report(n.stats))

with_worm = Sequentially((
    gworldline.PlaquetteUpdate(S),
    gworldline.VortexUpdate(S),
    gworldline.CoexactUpdate(S),
    gworldline.WrappingUpdate(S),
    gworldline.ClassicWorm(S),
))
w = sv.Ensemble(S).generate(args.configurations, with_worm, start='cold',
                            progress=sv.cli.progress, seed=2, device=args.device)
print(with_worm.report(w.stats))

n_tau = n.cut(10 * n.autocorrelation_time(args.observables)).autocorrelation_time(args.observables)
w_tau = w.cut(10 * w.autocorrelation_time(args.observables)).autocorrelation_time(args.observables)

print('Autocorrelation time')
print('--------------------')
print(f'Updates         {n_tau}')
print(f' + Worm         {w_tau}')

n_decorrelated = n.cut(10 * n_tau).every(n_tau)
w_decorrelated = w.cut(10 * w_tau).every(w_tau)
n_bootstrap = Bootstrap(n_decorrelated)
w_bootstrap = Bootstrap(w_decorrelated)

pulls = {}
print()
print(f'{"Observable":32s} {"Updates":>16s} {"+Worm":>16s} {"pull":>8s}')
for o in args.observables:
    ma, ea = n_bootstrap.estimate(o)
    mb, eb = w_bootstrap.estimate(o)
    pull = (ma - mb) / np.sqrt(ea ** 2 + eb ** 2)
    pulls[o] = pull
    print(f'{o:32s} {str(Uncertain(ma, ea)):>16s} {str(Uncertain(mb, eb)):>16s} {pull:+8.2f}')

if args.figure:
    import matplotlib
    matplotlib.use('Agg')
    from supervillain_tpu_torch.analysis import comparison_plot
    fig, ax = comparison_plot.setup(args.observables)
    comparison_plot.bootstraps(ax, (n_bootstrap, w_bootstrap), ('Updates', ' + Worm'),
                               observables=args.observables)
    comparison_plot.histories(ax, (n, w), ('Updates', ' + Worm'),
                              observables=args.observables)
    fig.suptitle(f'Worldline D={args.D} N={args.N} κ={args.kappa} W={args.W}')
    fig.tight_layout()
    fig.savefig(args.figure)
    print(f'wrote {args.figure}')
