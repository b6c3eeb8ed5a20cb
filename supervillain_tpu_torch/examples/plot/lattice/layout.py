#!/usr/bin/env python
"""Documentation figure: the lattice layout, one unit site (0-form), the two
unit links (1-form) and one unit plaquette (2-form) at the origin on the same
axes.  The port of ``examples/plot/lattice/layout.py``; needs matplotlib (the
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

import supervillain_tpu_torch as sv

parser = sv.cli.ArgumentParser()
parser.add_argument('--N', type=int, default=5, help='Sites on a side.')
parser.add_argument('--figure', default='layout.png', type=str)
args = parser.parse_args()

L = sv.Lattice2D(args.N)
fig, ax = plt.subplots(1, 1, figsize=(7, 6))

site = np.zeros((1, args.N, args.N))
site[0, 0, 0] = 1

link = np.zeros((2, args.N, args.N))
link[:, 0, 0] = 1

plaquette = np.zeros((1, args.N, args.N))
plaquette[0, 0, 0] = 1

L.plot_form(0, site, ax)
L.plot_form(1, link, ax)
L.plot_form(2, plaquette, ax)

ax.set_xlabel('0th direction')
ax.set_ylabel('1st direction')
fig.tight_layout()
fig.savefig(args.figure)
print(f'wrote {args.figure}')
