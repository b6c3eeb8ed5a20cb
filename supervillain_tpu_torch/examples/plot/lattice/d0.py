#!/usr/bin/env python
"""Documentation figure: the exterior derivative d on a delta-function 0-form:
d maps a unit site to the links on its coboundary with signs.  The port of
``examples/plot/lattice/d0.py``; needs matplotlib (the host only)."""

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
parser.add_argument('--figure', default='d0.png', type=str)
args = parser.parse_args()

L = sv.Lattice2D(args.N)

scalar = np.zeros((1, args.N, args.N))
scalar[0, 0, 0] = 1

fig, ax = plt.subplots(1, 2, figsize=(14, 6))
L.plot_form(0, scalar, ax[0], label=r'$f$')
L.plot_form(1, d(L, 0, torch.as_tensor(scalar)), ax[1], label=r'$df$')
ax[0].set_title('unit 0-form f')
ax[1].set_title('df (1-form on the coboundary links)')
for a in ax.ravel():
    a.set_xlabel('0th direction')
    a.set_ylabel('1st direction')
fig.tight_layout()
fig.savefig(args.figure)
print(f'wrote {args.figure}')
