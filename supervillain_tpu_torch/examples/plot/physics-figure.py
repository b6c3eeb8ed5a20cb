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

import re

import numpy as np

import matplotlib
matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

import supervillain_tpu_torch as sv  # noqa: E402
from supervillain_tpu_torch.analysis.scaling import crossing_estimate_error  # noqa: E402

SURFACE = '#fcfcfb'
INK = '#0b0b0b'
INK2 = '#52514e'
GRID = '#e4e3df'
SERIES = {64: '#2a78d6', 128: '#eb6834', 256: '#1baf7a', 512: '#eda100'}

plt.rcParams.update({
    'figure.facecolor': SURFACE, 'axes.facecolor': SURFACE,
    'savefig.facecolor': SURFACE,
    'text.color': INK, 'axes.labelcolor': INK,
    'xtick.color': INK2, 'ytick.color': INK2,
    'axes.edgecolor': INK2, 'axes.linewidth': 0.8,
    'grid.color': GRID, 'grid.linewidth': 0.8,
    'font.size': 11, 'axes.titlesize': 11.5,
    'legend.frameon': False,
})


def load_channel(pattern, channel):
    """{L: {kappa: (val, err)}} from every results file matching pattern."""
    data = {}
    for path in sorted(ROOT.glob(f'results/{pattern}')):
        m = re.search(r'-L(\d+)', path.name)
        if not m:
            continue
        L = int(m.group(1))
        with sv.cli.h5py().File(path, 'r') as f:
            groups = sv.io.read(f)
        for key, g in groups.items():
            kappa = round(float(key.split('_', 1)[1]), 4)
            if channel in g:
                v, e = np.asarray(g[channel])
                data.setdefault(L, {})[kappa] = (float(v), float(e))
    return data


def kc_band(data, pair):
    ks = sorted(set(data[pair[0]]) & set(data[pair[1]]))
    if len(ks) < 2:
        return None
    scaled = {L: np.array([data[L][k][0] for k in ks]) for L in pair}
    errs = {L: np.array([data[L][k][1] for k in ks]) for L in pair}
    kc, err, frac = crossing_estimate_error(ks, scaled, errs, draws=2000,
                                            pair=pair)
    return (kc, err) if kc is not None else None


def panel_curves(ax, data, ylabel, title, band=None, band_label=None):
    if band:
        kc, err = band
        ax.axvspan(kc - err, kc + err, color=GRID, zorder=0)
        ax.axvline(kc, color=INK2, lw=0.8, ls=':', zorder=1)
    for L in sorted(data):
        ks = sorted(data[L])
        v = np.array([data[L][k][0] for k in ks])
        e = np.array([data[L][k][1] for k in ks])
        ax.errorbar(ks, v, yerr=e, color=SERIES[L], lw=2, ms=5, marker='o',
                    capsize=2, label=f'L={L}', zorder=3)
        kmax = max(max(data[Li]) for Li in data)
        if ks[-1] == kmax:                  # uncrowded right edge: direct label
            ax.annotate(f'L={L}', (ks[-1], v[-1]), textcoords='offset points',
                        xytext=(6, -2), color=INK2, fontsize=9)
    ax.set_yscale('log')
    ax.grid(True, which='major', axis='both', zorder=0)
    ax.set_xlabel('κ')
    ax.set_ylabel(ylabel)
    ax.set_title(title, loc='left', color=INK)
    if band and band_label:
        kc, err = band
        ax.annotate(band_label, (kc, ax.get_ylim()[0]),
                    textcoords='offset points', xytext=(8, 10),
                    color=INK2, fontsize=9)
    ax.legend(loc='best', fontsize=9)


def winf_points():
    """(kappa, eta_exact, eta_eff(128→256), err) rows from the committed log."""
    rows = []
    log = ROOT / 'results' / 'winf-line.log'
    for line in log.read_text().splitlines():
        m = re.match(r'\s*([\d.]+)\s+([\d.]+)\s+\+.*?'
                     r'([\d.]+)\(([\d.]+)\)\s+([\d.]+)\(([\d.]+)\)\s+\[',
                     line)
        if m:
            k, exact = float(m.group(1)), float(m.group(2))
            eta, err = float(m.group(5)), float(m.group(6))
            rows.append((k, exact, eta, err))
    return sorted(rows)


def main():
    parser = sv.cli.ArgumentParser(description='The three-panel physics summary figure.')
    parser.add_argument('--figure', required=True, type=str,
                        help='where to write the figure (a .png path)')
    args = parser.parse_args()
    w2 = load_channel('bkt-scan-W2-L*.h5', 'chi_scaled')
    w3 = load_channel('bkt-scan-W3-L*.h5', 'chiV_scaled')
    # Round-5 L=256 high-stats triple (committed log bkt-scan-W3-L256-r5.log).
    w3.setdefault(256, {}).update({0.075: (1.491, 0.068),
                                   0.080: (0.894, 0.054),
                                   0.085: (0.614, 0.038)})

    fig, axes = plt.subplots(1, 3, figsize=(13.5, 4.2), constrained_layout=True)

    band2 = kc_band(w2, (256, 512)) or kc_band(w2, (128, 256))
    panel_curves(axes[0], w2, r'$\chi_S\,/\,L$', 'a   W=2 — self-dual spin channel',
                 band=band2, band_label='κ_c')

    pair3 = (256, 512) if 512 in w3 else (128, 256)
    band3 = kc_band(w3, pair3)
    panel_curves(axes[1], w3, r'$\chi_V\,/\,L^{14/9}$',
                 'b   W=3 — transition visible only in the dual channel',
                 band=band3, band_label='κ_c')

    ax = axes[2]
    rows = winf_points()
    ks = np.geomspace(0.06, 1.6, 200)
    ax.plot(ks, 1 / (2 * np.pi * ks), color=INK2, lw=2,
            label='exact 1/(2πκ)')
    k, _, eta, err = map(np.array, zip(*rows))
    ax.errorbar(k, eta, yerr=err, color=SERIES[256], lw=0, elinewidth=2,
                marker='o', ms=6, capsize=2, label='measured η_eff(128→256)')
    ax.set_xscale('log')
    ax.set_yscale('log')
    ax.grid(True, zorder=0)
    ax.set_xlabel('κ')
    ax.set_ylabel(r'$\eta$')
    ax.set_title('c   W=∞ — exact η(κ) = 1/(2πκ)', loc='left')
    ax.legend(loc='best', fontsize=9)

    out = args.figure
    fig.savefig(out, dpi=160)
    print(f'wrote {out}')
    if band2:
        print(f'W=2 kappa_c band: {band2[0]:.4f} +- {band2[1]:.4f}')
    if band3:
        print(f'W=3 kappa_c band ({pair3[0]}/{pair3[1]}): '
              f'{band3[0]:.4f} +- {band3[1]:.4f}')


if __name__ == '__main__':
    main()
