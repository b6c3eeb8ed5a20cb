#!/usr/bin/env python
"""Documentation figure: the codifferential δ on a delta-function 2-form: δ
maps a unit plaquette to the four links on its boundary with orientation
signs.  The port of ``examples/plot/lattice/delta2.py``; needs matplotlib (the
host only)."""

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
from supervillain_tpu_torch.ops.calculus import delta

parser = sv.cli.ArgumentParser()
parser.add_argument('--N', type=int, default=5, help='Sites on a side.')
parser.add_argument('--figure', default='delta2.png', type=str)
args = parser.parse_args()

L = sv.Lattice2D(args.N)

plaquette = np.zeros((1, args.N, args.N))
plaquette[0, 1, 1] = 1

fig, ax = plt.subplots(1, 2, figsize=(14, 6))
L.plot_form(2, plaquette, ax[0], label=r'$p$')
L.plot_form(1, delta(L, 2, torch.as_tensor(plaquette)), ax[1], label=r'$\delta p$')
ax[0].set_title('unit 2-form p')
ax[1].set_title('δp (1-form on the boundary links)')
for a in ax.ravel():
    a.set_xlabel('0th direction')
    a.set_ylabel('1st direction')
fig.tight_layout()
fig.savefig(args.figure)
print(f'wrote {args.figure}')
