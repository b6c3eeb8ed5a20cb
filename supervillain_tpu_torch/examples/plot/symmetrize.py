#!/usr/bin/env python
"""Documentation figure: hyperoctahedral symmetrization of a correlator, raw
Spin_Spin against L.symmetrize(Spin_Spin): the port of
``examples/plot/symmetrize.py``.

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

parser = sv.cli.ArgumentParser()
parser.add_argument('--N', type=int, default=7)
parser.add_argument('--kappa', type=float, default=0.4)
parser.add_argument('--configurations', type=int, default=2000)
parser.add_argument('--figure', default='symmetrize.png', type=str)
parser.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
args = parser.parse_args()

L = sv.Lattice2D(args.N)
S = sv.Villain(L, args.kappa, W=1)
e = sv.Ensemble(S).generate(args.configurations, gvillain.Hammer(S), start='cold',
                            progress=sv.cli.progress, device=args.device)

raw = torch.as_tensor(e.Spin_Spin).cpu().numpy().mean(axis=0)
sym = np.asarray(L.symmetrize(raw))

fig, ax = plt.subplots(1, 2, figsize=(12, 6))
for a, (c, title) in zip(ax, ((raw, 'raw ⟨S(Δx)⟩'), (sym, 'symmetrized'))):
    im = a.imshow(np.real(c).T, origin='lower', cmap='viridis')
    plt.colorbar(im, ax=a)
    a.set_title(title)
    a.set_xlabel('Δt')
    a.set_ylabel('Δx')
fig.tight_layout()
fig.savefig(args.figure)
print(f'wrote {args.figure}')
