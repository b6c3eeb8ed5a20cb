#!/usr/bin/env python
""""""

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
from supervillain_tpu_torch.analysis.eta_fit import eta_fit, eta_fit_profile
from supervillain_tpu_torch.analysis.scaling import crossing_estimate, crossing_estimate_error

W = 3
DeltaV = 2 / W ** 2                       # 2/9
DeltaS = W ** 2 / 8                       # 9/8 > 1: spin channel irrelevant

# Per-volume artifact files, merged in order (later files override shared κ —
# the dedicated high-statistics runs supersede the wide early scans).
FILES = {
    64: ['bkt-scan-W3-L64.h5'],
    128: ['bkt-scan-W3-L128.h5', 'bkt-scan-W3-L128-hiworm.h5'],
    256: ['bkt-scan-W3-L256.h5', 'bkt-scan-W3-L256-hiworm.h5'],
    512: ['bkt-scan-W3-L512-r5-compact.h5'],
}

# The round-5 L=256 high-stats triple (64 chains × 24 records × 24
# worms/record, therm 8L², records L²/8 apart) survives in its committed log,
# results/bkt-scan-W3-L256-r5.log — the raw h5 held only the (too large to
# commit) worm histograms.  χ_V/L^{14/9} as printed there:
LOG_POINTS = {
    256: {0.075: (1.491, 0.068), 0.080: (0.894, 0.054), 0.085: (0.614, 0.038)},
}


def load():
    data = {}
    for L, names in FILES.items():
        for name in names:
            path = ROOT / 'results' / name
            if not path.exists():
                continue
            with sv.cli.h5py().File(path, 'r') as f:
                groups = sv.io.read(f)
            for key, g in groups.items():
                kappa = round(float(key.split('_', 1)[1]), 4)
                row = {col: np.asarray(g[col])
                       for col in ('chi', 'chiV_scaled')
                       if col in g}
                if 'nontrivial_sector_frac' in g:
                    row['sect'] = float(np.asarray(
                        g['nontrivial_sector_frac']))
                data.setdefault(L, {})[kappa] = row
    for L, pts in LOG_POINTS.items():
        for kappa, (m, e) in pts.items():
            data.setdefault(L, {}).setdefault(round(kappa, 4), {})[
                'chiV_scaled'] = np.array([m, e])
    return data


def main():
    data = load()
    LS = sorted(data)
    kappas = sorted(set.union(*(set(d) for d in data.values())))
    print(f'# W=3: Delta_vortex = {DeltaV:.4g} (critical), '
          f'Delta_spin = {DeltaS} > 1 (irrelevant — χ_S finite through κ_c)')
    print(f'{"κ":>6} ' + ' '.join(f'{f"χV/L^14/9 (L={L})":>18}' for L in LS)
          + f' {"χ_S(L_max)":>12} {"sect":>5}')
    for k in kappas:
        cells = []
        for L in LS:
            row = data[L].get(k, {})
            if 'chiV_scaled' in row:
                m, e = row['chiV_scaled']
                cells.append(f'{m:>13.4g}({e:.2g})')
            else:
                cells.append(f'{"—":>18}')
        chiS = data[LS[-1]].get(k, data[LS[-2]].get(k, {})).get('chi')
        s = f'{chiS[0]:>9.3g}({chiS[1]:.2g})' if chiS is not None else f'{"—":>12}'
        sect = next((data[L][k]['sect'] for L in LS
                     if k in data[L] and 'sect' in data[L][k]), float('nan'))
        print(f'{k:>6.3f} ' + ' '.join(cells) + f' {s:>12} {sect:>5.2f}')

    print()
    for La, Lb in zip(LS[:-1], LS[1:]):
        ks = [k for k in kappas
              if 'chiV_scaled' in data[La].get(k, {})
              and 'chiV_scaled' in data[Lb].get(k, {})]
        if len(ks) < 2:
            print(f'crossing({La},{Lb}): <2 common κ')
            continue
        scaled = {L: np.array([data[L][k]['chiV_scaled'][0] for k in ks])
                  for L in (La, Lb)}
        errs = {L: np.array([data[L][k]['chiV_scaled'][1] for k in ks])
                for L in (La, Lb)}
        kc, err, frac = crossing_estimate_error(ks, scaled, errs, draws=4000,
                                                pair=(La, Lb))
        center = crossing_estimate(ks, scaled)
        if kc is None:
            print(f'crossing({La},{Lb}): none in {ks} ({frac:.0%} of draws)')
        else:
            print(f'crossing({La},{Lb}) grid={ks}: κ_c = {kc:.4f} ± {err:.4f} '
                  f'({frac:.0%} of draws cross)')

    # Shape-fit exponents from whatever histogram representations are present.
    printed_header = False
    for L, names in FILES.items():
        for name in names:
            path = ROOT / 'results' / name
            if not path.exists():
                continue
            with sv.cli.h5py().File(path, 'r') as f:
                groups = sv.io.read(f)
            for key in sorted(groups):
                g = groups[key]
                if 'Vortex_Vortex_hist' in g:
                    eta, err = eta_fit(np.asarray(g['Vortex_Vortex_hist']))
                elif 'profile' in g:
                    eta, err = eta_fit_profile(
                        np.asarray(g['r2']), np.asarray(g['mult']),
                        np.asarray(g['rr']), np.asarray(g['profile']))
                else:
                    continue
                if not printed_header:
                    print(f'\n# chord-model shape fits '
                          f'(prediction at κ_c: η_V = 2Δ_V = {2 * DeltaV:.4g})')
                    printed_header = True
                kappa = float(key.split('_', 1)[1])
                print(f'L={L:>4} κ={kappa:.3f}: η_V = {eta:.3f} ± {err:.3f}'
                      f'   [{name}]')


if __name__ == '__main__':
    main()
