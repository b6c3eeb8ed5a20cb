#!/usr/bin/env python
"""Documentation figure: a sampled Villain configuration, φ (0-form), n
(1-form) and dφ − 2πn, on a 2D lattice: the port of ``examples/plot/forms.py``.

Samples on the card (``--device cuda``, the default) or, with ``--device
cpu``, through the plain PyTorch versions; the figure needs matplotlib (the
host only).  The progress bar shows where tqdm imports."""

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
import numpy as np
import torch

import supervillain_tpu_torch as sv
from supervillain_tpu_torch.generators import villain as gvillain
from supervillain_tpu_torch.generators import Sequentially
from supervillain_tpu_torch.ops.calculus import d

parser = sv.cli.ArgumentParser()
parser.add_argument('--N', type=int, default=5)
parser.add_argument('--kappa', type=float, default=0.1)
parser.add_argument('--configurations', type=int, default=1000)
parser.add_argument('--figure', default='forms.png', type=str)
parser.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
args = parser.parse_args()

L = sv.Lattice2D(args.N)
S = sv.Villain(L, args.kappa)
G = Sequentially((gvillain.SiteUpdate(S), gvillain.LinkUpdate(S)))
e = sv.Ensemble(S).generate(args.configurations, G, start='cold', progress=sv.cli.progress,
                            device=args.device)

cfg = e.configuration[-1]
phi, n = (torch.as_tensor(np.asarray(cfg[k])) for k in ('phi', 'n'))

fig, ax = plt.subplots(1, 3, figsize=(18, 6))
fig.suptitle(f'{S}', fontsize=16)
L.plot_form(0, phi, ax[0], label=r'$\phi$')
L.plot_form(1, n, ax[1], label=r'$n$')
L.plot_form(1, d(L, 0, phi) - 2 * 3.141592653589793 * n, ax[2],
            label=r'$d\phi - 2\pi n$')
fig.tight_layout()
fig.savefig(args.figure)
print(f'wrote {args.figure}')
