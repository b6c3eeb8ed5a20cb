#!/usr/bin/env python
"""Documentation figure: the exterior derivative d on delta-function 1-forms:
d maps a unit link to the plaquettes on its coboundary with orientation signs.
The port of ``examples/plot/lattice/d1.py``; needs matplotlib (the host only)."""

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
from supervillain_tpu_torch.ops.calculus import d

parser = sv.cli.ArgumentParser()
parser.add_argument('--N', type=int, default=5, help='Sites on a side.')
parser.add_argument('--figure', default='d1.png', type=str)
args = parser.parse_args()

L = sv.Lattice2D(args.N)

fig, ax = plt.subplots(2, 2, figsize=(14, 12))
for mu in range(2):
    link = np.zeros((2, args.N, args.N))
    link[mu, 1, 1] = 1
    L.plot_form(1, link, ax[mu, 0], label=rf'$\ell_{mu}$')
    L.plot_form(2, d(L, 1, torch.as_tensor(link)), ax[mu, 1], label=rf'$d\ell_{mu}$')
    ax[mu, 0].set_title(f'unit 1-form on a direction-{mu} link')
    ax[mu, 1].set_title('its exterior derivative (2-form)')
for a in ax.ravel():
    a.set_xlabel('0th direction')
    a.set_ylabel('1st direction')
fig.tight_layout()
fig.savefig(args.figure)
print(f'wrote {args.figure}')
