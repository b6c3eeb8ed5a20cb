#!/usr/bin/env python
"""Three-volume finite-size-scaling analysis of the W=2 generalized-BKT scan:
the port of ``examples/plot/w2-analysis.py``.  Reads the committed
results/bkt-scan-W2-L{64,128,256}.h5 through the port's ``io.read`` and prints
the scaled spin and vortex susceptibilities, the effective exponents and the
crossing estimates that pin κ_c(W=2).  Host-side analysis (NumPy and h5py;
no device), so it runs on the host only."""

# Allow running this script directly from anywhere: put the repo root (the
# directory containing the supervillain_tpu_torch package) on sys.path.
import pathlib as _pathlib
import sys as _sys
for _p in _pathlib.Path(__file__).resolve().parents:
    if (_p / 'supervillain_tpu_torch').is_dir():
        ROOT = _p
        if str(_p) not in _sys.path:
            _sys.path.insert(0, str(_p))
        break

import numpy as np

import supervillain_tpu_torch as sv
from supervillain_tpu_torch.analysis.scaling import (effective_exponent,
                                                     effective_exponent_error,
                                                     crossing_estimate)

LS = tuple(L for L in (64, 128, 256, 512) if (ROOT / f'results/bkt-scan-W2-L{L}.h5').exists())
W = 2
DeltaS = W ** 2 / 8          # 0.5
DeltaV = 2 / W ** 2          # 0.5


def load(L):
    out = {}
    with sv.cli.h5py().File(ROOT / f'results/bkt-scan-W2-L{L}.h5', 'r') as f:
        groups = sv.io.read(f)
    for key, g in groups.items():
        kappa = float(key.split('_', 1)[1])
        row = {'chi': np.asarray(g['chi']),
               'chi_scaled': np.asarray(g['chi_scaled'])}
        if 'chiV_scaled' in g:
            row['chiV_scaled'] = np.asarray(g['chiV_scaled'])
        if 'nontrivial_sector_frac' in g:
            row['sect'] = float(np.asarray(g['nontrivial_sector_frac']))
        out[round(kappa, 4)] = row
    return out


def main():
    data = {L: load(L) for L in LS}
    kappas = sorted(set.union(*(set(d) for d in data.values())))

    pairs = list(zip(LS[:-1], LS[1:]))
    print(f'# W=2: Delta_spin = {DeltaS}, Delta_vortex = {DeltaV} '
          f'(the exponent pair is self-dual at W=2: both scale chi/L)')
    print(f'{"κ":>6} ' + ' '.join(f'{f"χS/L (L={L})":>16}' for L in LS)
          + ' '.join(f' {f"η_eff({La}→{Lb})":>15}' for La, Lb in pairs)
          + f' {"sect":>5}')
    for k in kappas:
        cells = []
        for L in LS:
            if k in data[L]:
                m, e = data[L][k]['chi_scaled']
                cells.append(f'{m:>11.4g}({e:.2g})')
            else:
                cells.append(f'{"—":>16}')
        etas = []
        for La, Lb in pairs:
            if k not in data[La] or k not in data[Lb]:
                etas.append(f'{"—":>15}')
                continue
            ma, ea = data[La][k]['chi_scaled']
            mb, eb = data[Lb][k]['chi_scaled']
            _, eta = effective_exponent(La, ma * La, Lb, mb * Lb)
            err = effective_exponent_error(La, ma * La, ea * La, Lb, mb * Lb, eb * Lb)
            etas.append(f'{eta:>9.3f}({err:.3f})')
        sect = data[LS[0]][k].get('sect', float('nan'))
        print(f'{k:>6.2f} ' + ' '.join(f'{c:>16}' for c in cells)
              + ' '.join(etas) + f' {sect:>5.2f}')

    for (La, Lb) in pairs:
        ks = [k for k in kappas if k in data[La] and k in data[Lb]]
        a = np.array([data[La][k]['chi_scaled'][0] for k in ks])
        b = np.array([data[Lb][k]['chi_scaled'][0] for k in ks])
        x = crossing_estimate(np.array(ks), {La: a, Lb: b})
        print(f'crossing({La},{Lb}) at κ = '
              + (f'{x:.4f}' if x is not None else 'none in window'))

    if any('chiV_scaled' in row for d in data.values() for row in d.values()):
        print(f'\n{"κ":>6} ' + ' '.join(f'{f"χV/L (L={L})":>16}' for L in LS))
        for k in kappas:
            cells = []
            for L in LS:
                if k in data[L] and 'chiV_scaled' in data[L][k]:
                    m, e = data[L][k]['chiV_scaled']
                    cells.append(f'{m:>11.4g}({e:.2g})')
                else:
                    cells.append(f'{"—":>16}')
            print(f'{k:>6.2f} ' + ' '.join(f'{c:>16}' for c in cells))


if __name__ == '__main__':
    main()
