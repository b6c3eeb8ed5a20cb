#!/usr/bin/env python
"""Documentation figure: generate two Villain ensembles the same way and compare
their histories, histograms and bootstraps column by column, the standard
3-column comparison figure: the port of ``examples/plot/comparison.py``.

Samples on the card (``--device cuda``, the default) or, with ``--device
cpu``, through the plain PyTorch versions; the figure needs matplotlib, which
the host has and the card's machine has not, so the script runs on the host.
The progress bar shows where tqdm imports."""

# Allow running this script directly from anywhere: put the repo root (the
# directory containing the supervillain_tpu_torch package) on sys.path.
import pathlib as _pathlib
import sys as _sys
for _p in _pathlib.Path(__file__).resolve().parents:
    if (_p / 'supervillain_tpu_torch').is_dir():
        if str(_p) not in _sys.path:
            _sys.path.insert(0, str(_p))
        break

import matplotlib
matplotlib.use('Agg')
import matplotlib.pyplot as plt

import supervillain_tpu_torch as sv
from supervillain_tpu_torch.analysis import Bootstrap
from supervillain_tpu_torch.analysis import comparison_plot
from supervillain_tpu_torch.generators import Sequentially
from supervillain_tpu_torch.generators import villain as gvillain

parser = sv.cli.ArgumentParser(
    description='Generate two Villain ensembles the same way and compare their results.')
parser.add_argument('--N', type=int, default=5, help='Sites on a side.')
parser.add_argument('--kappa', type=float, default=0.1, help='κ.')
parser.add_argument('--configurations', type=int, default=10000)
parser.add_argument('--figure', default='comparison.png', type=str)
parser.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
args = parser.parse_args()

L = sv.Lattice2D(args.N)
S = sv.Villain(L, args.kappa)


def run(seed):
    G = Sequentially((gvillain.SiteUpdate(S), gvillain.LinkUpdate(S)))
    return sv.Ensemble(S).generate(args.configurations, G, start='cold',
                                   progress=sv.cli.progress, seed=seed, device=args.device)


ensembles = (run(0), run(1))
taus = tuple(e.autocorrelation_time() for e in ensembles)
thermalized = tuple(e.cut(10 * tau) for e, tau in zip(ensembles, taus))
taus = tuple(e.autocorrelation_time() for e in thermalized)
decorrelated = tuple(e.every(tau) for e, tau in zip(thermalized, taus))
boots = tuple(Bootstrap(e) for e in decorrelated)

fig, ax = comparison_plot.setup()
comparison_plot.bootstraps(ax, boots, ('First run', 'Second run'))
comparison_plot.histories(ax, ensembles, ('First run', 'Second run'))
fig.suptitle(f'Villain N={args.N} κ={args.kappa} W=1')
fig.tight_layout()
fig.savefig(args.figure)
print(f'wrote {args.figure}')
