#!/usr/bin/env python
"""Cross-check of Villain generator stacks: the composite NeighborhoodUpdate against
the Link+Site+Exact+Cohomology local stack (+Worm in D=2); every observable must
agree within Monte-Carlo error: the port of
``examples/villain-algorithm-comparison.py``.

Without the worm there is no W>1 ergodic Villain algorithm, so W=1 throughout.
Runs on the card (``--device cuda``, the default: the sweep and worm kernels,
at any N, odd or even) or, with ``--device cpu``, through the plain PyTorch
versions.  ``--figure`` needs matplotlib.  ``pulls`` holds the pull of each
observable.
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
from supervillain_tpu_torch.generators import villain as gvillain
from supervillain_tpu_torch.generators import Sequentially

parser = sv.cli.ArgumentParser(description='Villain generator-stack comparison.')
parser.add_argument('--D', type=int, default=2)
parser.add_argument('--N', type=int, default=5)
parser.add_argument('--kappa', type=float, default=0.25)
parser.add_argument('--configurations', type=int, default=10000)
parser.add_argument('--figure', default=False, type=str)
parser.add_argument('--observables', nargs='*',
                    default=('ActionDensity', 'InternalEnergyDensity',
                             'InternalEnergyDensitySquared', 'WindingSquared'))
parser.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
args = parser.parse_args()

L = sv.Lattice(args.D, args.N)
S = sv.Villain(L, args.kappa, W=1)

neighborhood = Sequentially((gvillain.NeighborhoodUpdate(S),))
n = sv.Ensemble(S).generate(args.configurations, neighborhood, start='cold',
                            progress=sv.cli.progress, seed=1, device=args.device)
print(neighborhood.report(n.stats))

local_generators = [
    gvillain.LinkUpdate(S),
    gvillain.SiteUpdate(S),
    gvillain.ExactUpdate(S),
    gvillain.CohomologyUpdate(S),
]
if args.D == 2:
    local_generators.append(gvillain.ClassicWorm(S))
local = Sequentially(tuple(local_generators))
w = sv.Ensemble(S).generate(args.configurations, local, start='cold',
                            progress=sv.cli.progress, seed=2, device=args.device)
print(local.report(w.stats))

n_tau = n.cut(10 * n.autocorrelation_time(args.observables)).autocorrelation_time(args.observables)
w_tau = w.cut(10 * w.autocorrelation_time(args.observables)).autocorrelation_time(args.observables)

print('Autocorrelation time')
print('--------------------')
print(f'Neighborhood    {n_tau}')
print(f'Local stack     {w_tau}')

n_bootstrap = Bootstrap(n.cut(10 * n_tau).every(n_tau))
w_bootstrap = Bootstrap(w.cut(10 * w_tau).every(w_tau))

pulls = {}
print()
print(f'{"Observable":32s} {"Neighborhood":>16s} {"Local stack":>16s} {"pull":>8s}')
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
    comparison_plot.bootstraps(ax, (n_bootstrap, w_bootstrap),
                               ('Neighborhood', 'Local stack'),
                               observables=args.observables)
    comparison_plot.histories(ax, (n, w), ('Neighborhood', 'Local stack'),
                              observables=args.observables)
    fig.suptitle(f'Villain D={args.D} N={args.N} κ={args.kappa} W=1')
    fig.tight_layout()
    fig.savefig(args.figure)
    print(f'wrote {args.figure}')
