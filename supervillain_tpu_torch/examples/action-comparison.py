#!/usr/bin/env python
"""Compute the same observables with the Villain and Worldline actions and check
they agree: the port of ``examples/action-comparison.py``.

Runs on the card (``--device cuda``, the default: the Hammers' worms launch the
worm kernels, at any N, odd or even) or, with ``--device cpu``, through the
plain PyTorch versions.  ``--figure`` needs matplotlib; the progress bar shows where
tqdm imports.  ``pulls`` holds (Villain − Worldline)/σ of each observable.
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
from supervillain_tpu_torch.generators import villain as gvillain, worldline as gworldline

parser = sv.cli.ArgumentParser(description='Villain vs Worldline observable comparison.')
parser.add_argument('--D', type=int, default=2)
parser.add_argument('--N', type=int, default=5)
parser.add_argument('--kappa', type=float, default=0.5)
parser.add_argument('--W', type=sv.cli.W, default=1)
parser.add_argument('--configurations', type=int, default=10000)
parser.add_argument('--figure', default=False, type=str)
parser.add_argument('--observables', nargs='*',
                    default=('ActionDensity', 'InternalEnergyDensity',
                             'InternalEnergyDensitySquared'))
parser.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
args = parser.parse_args()

L = sv.Lattice(args.D, args.N)
V = sv.Villain(L, args.kappa, W=args.W)
W = sv.Worldline(L, args.kappa, W=args.W)

gv = gvillain.Hammer(V)
v = sv.Ensemble(V).generate(args.configurations, gv, start='cold',
                            progress=sv.cli.progress, seed=1, device=args.device)
print(gv.report(v.stats))

gw = gworldline.Hammer(W)
w = sv.Ensemble(W).generate(args.configurations, gw, start='cold',
                            progress=sv.cli.progress, seed=2, device=args.device)
print(gw.report(w.stats))

v_tau = v.autocorrelation_time(observables=args.observables)
w_tau = w.autocorrelation_time(observables=args.observables)
v_thermalized = v.cut(10 * v_tau)
w_thermalized = w.cut(10 * w_tau)
v_tau = v_thermalized.autocorrelation_time(observables=args.observables)
w_tau = w_thermalized.autocorrelation_time(observables=args.observables)

print('Autocorrelation time')
print('--------------------')
print(f'Villain   {v_tau}')
print(f'Worldline {w_tau}')

v_decorrelated = v_thermalized.every(v_tau)
w_decorrelated = w_thermalized.every(w_tau)

v_bootstrap = Bootstrap(v_decorrelated)
w_bootstrap = Bootstrap(w_decorrelated)

pulls = {}
print()
print(f'{"Observable":32s} {"Villain":>16s} {"Worldline":>16s} {"pull":>8s}')
for o in args.observables:
    mv, ev = v_bootstrap.estimate(o)
    mw, ew = w_bootstrap.estimate(o)
    pull = (mv - mw) / np.sqrt(ev ** 2 + ew ** 2)
    pulls[o] = pull
    print(f'{o:32s} {str(Uncertain(mv, ev)):>16s} {str(Uncertain(mw, ew)):>16s} {pull:+8.2f}')

if args.figure:
    import matplotlib
    matplotlib.use('Agg')
    from supervillain_tpu_torch.analysis import comparison_plot
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    fig_obs, ax_obs = comparison_plot.setup(args.observables)
    comparison_plot.bootstraps(ax_obs, (v_bootstrap, w_bootstrap),
                               ('Villain', 'Worldline'), observables=args.observables)
    comparison_plot.histories(ax_obs, (v, w), ('Villain', 'Worldline'),
                              observables=args.observables)
    fig_obs.suptitle(f'D={args.D} W={args.W} κ={args.kappa} N={args.N}')
    fig_obs.tight_layout()

    correlators = (('Spin_Spin_Normalized', 'log'), ('Winding_Winding', 'linear'))
    fig_corr, ax_corr = plt.subplots(nrows=len(correlators), ncols=1, sharex=True,
                                     squeeze=False, figsize=(6, 3 * len(correlators)))
    ax_corr = ax_corr[:, 0]
    for ax, (correlator, yscale) in zip(ax_corr, correlators):
        v_bootstrap.plot_correlator(ax, correlator, label='Villain')
        w_bootstrap.plot_correlator(ax, correlator, label='Worldline')
        ax.set_yscale(yscale)
        ax.set_ylabel(correlator)
    ax_corr[0].legend()
    ax_corr[-1].set_xscale('log')
    ax_corr[-1].set_xlabel('Δx')
    fig_corr.tight_layout()

    with PdfPages(args.figure) as pdf:
        pdf.savefig(fig_obs)
        pdf.savefig(fig_corr)
    print(f'wrote {args.figure}')
