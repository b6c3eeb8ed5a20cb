#!/usr/bin/env python
"""W=∞ at the self-dual coupling κ = 1/2π: the Villain Spin_Spin correlator must
match the Worldline Vortex_Vortex correlator under duality: the port of
``examples/no-vortices.py``, with HDF5 caching of the bootstraps when ``--h5``
names a file (which needs h5py; without it nothing is cached).

Runs on the card (``--device cuda``, the default: the Hammers' worms launch the
worm kernels, at any N, odd or even) or, with ``--device cpu``, through the
plain PyTorch versions.  ``--pdf`` needs matplotlib.  ``pulls`` holds the pull of each
observable, ``correlator_pulls`` those of the self-dual correlator check.
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
from supervillain_tpu_torch.generators import villain as gvillain, worldline as gworldline

parser = sv.cli.ArgumentParser(description='W=∞ self-dual duality check.')
parser.add_argument('--N', type=int, default=11)
parser.add_argument('--kappa', type=float, default=0.5 / np.pi)
parser.add_argument('--configurations', type=int, default=10000)
parser.add_argument('--h5', default=None,
                    help='cache the bootstraps in this h5 file (needs h5py)')
parser.add_argument('--reset', default=False, action='store_true')
parser.add_argument('--pdf', type=str, default='')
parser.add_argument('--observables', nargs='*',
                    default=('ActionDensity', 'InternalEnergyDensity',
                             'InternalEnergyDensitySquared'))
parser.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
args = parser.parse_args()

W = float('inf')
L = sv.Lattice2D(args.N)


def path(action):
    return f'N={args.N}/kappa={args.kappa}/{action}'


def generate(action):
    if action == 'villain':
        S = sv.Villain(L, args.kappa, W=W)
        G = gvillain.Hammer(S)
    else:
        S = sv.Worldline(L, args.kappa, W=W)
        G = gworldline.Hammer(S)
    # zlib.crc32 is stable across processes (str hash() is salted per run).
    import zlib
    E = sv.Ensemble(S).generate(args.configurations, G, start='cold', progress=sv.cli.progress,
                                seed=zlib.crc32(action.encode()) % 2 ** 31, device=args.device)
    print(G.report(E.stats))
    return E


def decorrelate(E):
    tau = E.autocorrelation_time(args.observables)
    therm = E.cut(10 * tau)
    tau = therm.autocorrelation_time(args.observables)
    print(f'  autocorrelation time {tau}')
    return therm.every(tau)


h5py = sv.cli.h5py() if args.h5 else None
if h5py is None:
    print('no --h5 given: the bootstraps are neither read from nor written to a cache')

bootstrap = {}
for action in ('villain', 'worldline'):
    p = path(action)
    if h5py is not None and not args.reset:
        try:
            with h5py.File(args.h5, 'r') as file:
                if p in file:
                    ens = sv.Ensemble.from_h5(file[p + '/ensemble'], device=args.device)
                    bootstrap[action] = Bootstrap.from_h5(file[p + '/bootstrap'], ens)
                    print(f'loaded cached {p}')
                    continue
        except FileNotFoundError:
            pass

    E = generate(action)
    D = decorrelate(E)
    B = Bootstrap(D, 200)
    # Normalize the correlators at the origin, per draw.
    origin = (slice(None),) + L.origin
    B.Vortex_Vortex = B.Vortex_Vortex / B.Vortex_Vortex[origin][:, None, None]
    B.Spin_Spin = B.Spin_Spin / B.Spin_Spin[origin][:, None, None]
    bootstrap[action] = B
    if h5py is None:
        continue
    with h5py.File(args.h5, 'a') as file:
        if p in file:
            del file[p]
        g = file.create_group(p)
        D.to_h5(g.create_group('ensemble'))
        B.to_h5(g.create_group('bootstrap'))

# Observable agreement across the duality.
print()
print(f'{"Observable":32s} {"Villain":>16s} {"Worldline":>16s} {"pull":>8s}')
pulls = {}
for o in args.observables:
    mv, ev = bootstrap['villain'].estimate(o)
    mw, ew = bootstrap['worldline'].estimate(o)
    pull = (mv - mw) / np.sqrt(ev ** 2 + ew ** 2)
    pulls[o] = pull
    print(f'{o:32s} {str(Uncertain(mv, ev)):>16s} {str(Uncertain(mw, ew)):>16s} {pull:+8.2f}')

# Self-duality: Villain Spin_Spin ↔ Worldline Vortex_Vortex.
sv_spin = bootstrap['villain'].Spin_Spin.real
wl_vortex = bootstrap['worldline'].Vortex_Vortex.real
print()
print('Self-dual correlator check (Villain Spin_Spin vs Worldline Vortex_Vortex):')
correlator_pulls = []
for dx in [(0, 1), (1, 1), (2, 2), (0, args.N // 2)]:
    a, ea = sv_spin.mean(axis=0)[dx], sv_spin.std(axis=0)[dx]
    b, eb = wl_vortex.mean(axis=0)[dx], wl_vortex.std(axis=0)[dx]
    pull = (a - b) / np.hypot(ea, eb)
    correlator_pulls.append(pull)
    print(f'  Δx={dx}: {Uncertain(a, ea)} vs {Uncertain(b, eb)}  pull {pull:+.2f}')

if args.pdf:
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages
    fig, ax = plt.subplots(1, 1, figsize=(6, 4))
    bootstrap['villain'].plot_correlator(ax, 'Spin_Spin', label='Villain Spin_Spin')
    bootstrap['worldline'].plot_correlator(ax, 'Vortex_Vortex', offset=0.05,
                                           label='Worldline Vortex_Vortex')
    ax.set_xscale('log')
    ax.set_yscale('log')
    ax.legend()
    kappa_str = '1/2π' if args.kappa == 0.5 / np.pi else str(args.kappa)
    fig.suptitle(f'W=∞ κ={kappa_str} N={args.N}')
    with PdfPages(args.pdf) as pdf:
        pdf.savefig(fig)
    print(f'wrote {args.pdf}')
