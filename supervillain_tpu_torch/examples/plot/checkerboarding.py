#!/usr/bin/env python
"""Documentation figure: the checkerboard colorings that make same-color sites
update-independent: the port of ``examples/plot/checkerboarding.py``.  Even N
uses 2 colors; odd N needs the multi-color decomposition.  Needs matplotlib
(the host only)."""

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
parser.add_argument('--Ns', type=int, nargs='*', default=(4, 5))
parser.add_argument('--figure', default='checkerboarding.png', type=str)
args = parser.parse_args()

fig, ax = plt.subplots(1, len(args.Ns), figsize=(6 * len(args.Ns), 6), squeeze=False)
for a, N in zip(ax[0], args.Ns):
    L = sv.Lattice2D(N)
    masks = L.checkerboard_masks  # (colors, N, N) boolean masks
    labels = np.zeros((N, N), dtype=int)
    for c, mask in enumerate(np.asarray(masks)):
        labels[np.asarray(mask, dtype=bool)] = c
    im = a.imshow(labels.T, origin='lower', cmap='tab10', vmin=0, vmax=9)
    a.set_title(f'N={N}: {len(masks)} colors')
    a.set_xlabel('t')
    a.set_ylabel('x')
fig.tight_layout()
fig.savefig(args.figure)
print(f'wrote {args.figure}')
