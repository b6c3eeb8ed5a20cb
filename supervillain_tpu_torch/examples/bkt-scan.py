#!/usr/bin/env python
"""BKT scan at L=256: a fleet κ-scan across the W=1 critical coupling κ_c ≈ 0.74
driven by the fused neighborhood sweep (and, at W > 1, the fused Hammer: sweeps
then worms), the port of ``examples/bkt-scan.py``, with

* inline ActionDensity / WindingSquared measured in the kernels every sweep, and
* periodic spin-correlator measurements: per chain, χ_S = Σ_r C(r)/C(0) of
  C = correlation(e^{iφ}, e^{iφ}) (the math of Spin_Spin.Villain), computed on
  the chains' device between kernel calls, of which only the (chains,) column
  comes to the host; bootstrapped into χ_S and χ_S/L^{D−2Δ} with Δ = W²/8.

Across the scan the scaled susceptibility χ_S/L^{D−2Δ} rises steeply through
κ_c as the spin correlator turns from exponential decay to the critical
power law, the generalized-BKT signature.

The inline columns are one value per chain (the JAX script's are one per
Pallas program, which packs several chains at small L), so the bootstrap over
per-chain time means has as many samples as chains.

Runs on the card (``--device cuda``, the default; the sweep kernel takes any
L, an odd one through its four-color table) or, with ``--device cpu``, through
the plain PyTorch versions, at the size asked for in either case.  ``--h5`` (which needs h5py) stores the run's
configuration as attributes of the file and each κ as a group when it
finishes; a file written with another configuration is refused, not appended
to.  ``main()`` returns ``{κ: results}``.
"""

# Allow running this script directly from anywhere: put the repo root (the
# directory containing the supervillain_tpu_torch package) on sys.path.
import pathlib as _pathlib
import sys as _sys
for _p in _pathlib.Path(__file__).resolve().parents:
    if (_p / 'supervillain_tpu_torch').is_dir():
        if str(_p) not in _sys.path:
            _sys.path.insert(0, str(_p))
        break

import time

import numpy as np
import torch

import supervillain_tpu_torch as sv
from supervillain_tpu_torch.analysis import Bootstrap, Uncertain
from supervillain_tpu_torch.configurations import Configurations
from supervillain_tpu_torch.device import field_dtypes, resolve_device
from supervillain_tpu_torch.ensemble import Ensemble
from supervillain_tpu_torch.ops.hammer import hammer_sweeps
from supervillain_tpu_torch.ops.sweep import neighborhood_sweeps
from supervillain_tpu_torch.parallel.fused_fleet import check_truncation_budget


def scan_config(args, worms):
    """The settings a scan's h5 file records as attributes; a second scan may
    append to the file only if it has the same ones."""
    return {'L': args.L, 'chains': args.chains, 'W': args.W, 'worms': worms,
            'therm_sweeps': args.therm_sweeps, 'thin': args.thin, 'records': args.records,
            'p_n': args.p_n, 'bootstraps': args.bootstraps}


def open_scan_file(h5py, path, config):
    """Check ``path`` against the run's ``config``, writing the config into a
    new (or empty) file.  A file that holds another config, or κ groups and no
    config, raises ValueError: its groups could not be told from this run's."""
    with h5py.File(path, 'a') as f:
        stored = {k: v.item() for k, v in f.attrs.items()}
        if not stored and len(f) == 0:
            for k, v in config.items():
                f.attrs[k] = v
            return
        if stored != config:
            raise ValueError(f'{path} holds a scan with the configuration {stored or "unknown"}, '
                             f'not {config}; write this scan to another file')


def main():
    ap = sv.cli.ArgumentParser(description=__doc__)
    ap.add_argument('--L', type=int, default=256)
    ap.add_argument('--chains', type=int, default=32)
    ap.add_argument('--therm-sweeps', type=int, default=400)
    ap.add_argument('--records', type=int, default=24)
    ap.add_argument('--thin', type=int, default=25, help='fused sweeps per record')
    ap.add_argument('--kappas', type=float, nargs='+',
                    default=[0.55, 0.65, 0.74, 0.85, 1.00])
    ap.add_argument('--p_n', type=float, default=0.05,
                    help='zero-inflated Δn proposal probability (mixing at scale)')
    ap.add_argument('--bootstraps', type=int, default=100)
    ap.add_argument('--h5', type=str, default=None, help='write per-κ results here')
    ap.add_argument('--save-hist', action='store_true',
                    help='also store the per-chain summed worm histogram '
                         '(Vortex_Vortex, (chains, L, L)) in the h5 — enables '
                         'offline shape fits G_V(r) ~ r^{-η} at criticality, '
                         'which beat the origin-normalized susceptibility '
                         'ratio on η precision')
    ap.add_argument('--W', type=int, default=1,
                    help='finite vortex constraint; Δ = W²/8 scales the '
                         'susceptibility, Δn proposals come in multiples of W')
    ap.add_argument('--worms', type=int, default=None,
                    help='classic worms per `thin` sweeps (fused Hammer).  '
                         'Default: 1 at W>1, 0 at W=1.  At W>1 the bare '
                         'neighborhood sweep only changes n in multiples of W, '
                         'freezing the Z_W winding sectors at their cold-start '
                         'value — worms restore ergodicity there AND supply '
                         'the inline vortex correlator.')
    ap.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()

    device = resolve_device(args.device)
    N, B = args.L, args.chains
    L = sv.Lattice2D(N)
    W = args.W
    worms = args.worms if args.worms is not None else (0 if W == 1 else 1)
    Delta = W ** 2 / 8
    scale = N ** (L.D - 2 * Delta)
    # Dual (vortex-sector) exponent: Δ_V = 2/W², the generalized-BKT pair.
    DeltaV = 2 / W ** 2
    scaleV = N ** (L.D - 2 * DeltaV)
    fdt, idt = field_dtypes(device)

    h5py = None
    if args.h5:
        h5py = sv.cli.h5py()
        open_scan_file(h5py, args.h5, scan_config(args, worms))

    def launch(phi, n, sweeps, kappa, rng):
        common = dict(kappa=kappa, W=W, interval_phi=0.7, interval_n=1, p_n=args.p_n,
                      sweeps=sweeps, generator=rng)
        if worms > 0:
            # Scale the worm count with the launch length so thermalization
            # chunks keep the same worms-per-sweep density as measurements.
            # Worms are capped at 64·N² moves (exact truncation-rollback);
            # the recorded truncation fraction bounds the (χ_V-only) bias.
            return hammer_sweeps(phi, n, worms=max(1, (worms * sweeps) // max(args.thin, 1)),
                                 max_worm_moves=64 * N * N, **common)
        return neighborhood_sweeps(phi, n, **common)

    def spin_susceptibility(phi):
        """Per-chain χ_S = Σ_r C(r) / C(0), C = correlation(e^{iφ}, e^{iφ}).real."""
        spin = torch.polar(torch.ones_like(phi[:, 0]), phi[:, 0])
        corr = L.correlation(spin, spin).real
        return (corr.sum(dim=(1, 2)) / corr[:, 0, 0]).cpu().numpy()

    expect = '  (κ_c ≈ 0.74 expected)' if W == 1 else ''
    print(f'# L={N} chains={B} W={W} Δ={Delta} Δ_V={DeltaV} worms/record={worms}{expect}')
    head = (f'{"κ":>6} {"acc":>6} {"ActionDensity":>16} {"WindingSq":>14} '
            f'{"χ_S":>14} {"χ_S/L^(D-2Δ)":>14}')
    if worms > 0:
        head += f' {"χ_V/L^(D-2Δ_V)":>15}'
    print(head)

    results = {}
    for kappa in args.kappas:
        t0 = time.perf_counter()
        rng = torch.Generator(device=device).manual_seed(20260820)
        phi = torch.zeros((B, 1, N, N), dtype=fdt, device=device)
        n = torch.zeros((B, 2, N, N), dtype=idt, device=device)

        # Chunk thermalization into bounded calls of at most 4096 sweeps.
        remaining = args.therm_sweeps
        while remaining > 0:
            chunk = min(remaining, 4096)
            phi, n, _, _ = launch(phi, n, chunk, kappa, rng)
            remaining -= chunk

        S_rows, W2_rows = [], []
        chi_col = np.empty((args.records, B))
        histV = torch.zeros((B, N, N), dtype=torch.float64, device=device)
        accepted = torch.zeros((), dtype=torch.float64, device=device)
        truncated = torch.zeros((), dtype=torch.float64, device=device)
        for r in range(args.records):
            phi, n, acc, inline = launch(phi, n, args.thin, kappa, rng)
            accepted += acc.sum()
            if worms > 0:
                truncated += inline['Worm_Truncated'].sum()
                histV += inline['Vortex_Vortex']
            S_rows.append(inline['ActionDensity'].cpu().numpy())
            W2_rows.append(inline['WindingSquared'].cpu().numpy())
            chi_col[r] = spin_susceptibility(phi)
        S_col = np.stack(S_rows)
        W2_col = np.stack(W2_rows)
        # Per-chain Z_W holonomy bits (w_t, w_x) mod W: the homological sectors
        # only torus-wrapping worms can change.
        wt = torch.remainder(n[:, 0, :, 0].sum(dim=1), W)
        wx = torch.remainder(n[:, 1, 0, :].sum(dim=1), W)
        nontrivial_sectors = float((wt != 0).double().mean() + (wx != 0).double().mean()) / 2
        accepted, truncated = float(accepted), float(truncated)
        acc_frac = accepted / (B * N * N * args.thin * args.records)

        # Bootstrap over per-chain means: chains are independent by
        # construction, while records within one chain stay correlated
        # whenever thin < τ — pooling them would understate errors.  Past a
        # truncated fraction of 1e-3 of the measurement worms the inline
        # correlator carries a short-separation bias, and a warning says so.
        trunc_frac = check_truncation_budget(
            truncated, worms * args.records * B, context=f'kappa={kappa}: ') \
            if worms > 0 else 0.0

        S_action = sv.Villain(L, kappa, W)
        histV = histV.cpu().numpy()
        cols = {'SpinSusceptibility': chi_col.mean(axis=0)}
        if worms > 0:
            origin = np.maximum(histV[:, 0, 0], 1e-30)
            cols['VortexSusceptibility'] = histV.sum(axis=(1, 2)) / origin
        e = Ensemble(S_action).from_configurations(Configurations(cols), device=device)
        b = Bootstrap(e, draws=args.bootstraps)
        ep = Ensemble(S_action).from_configurations(Configurations({
            'ActionDensity': S_col.mean(axis=0),
            'WindingSquared': W2_col.mean(axis=0),
        }), device=device)
        bp = Bootstrap(ep, draws=args.bootstraps)
        mS, eS = bp.estimate('ActionDensity')
        mW, eW = bp.estimate('WindingSquared')
        mX, eX = b.estimate('SpinSusceptibility')
        results[kappa] = dict(acc=acc_frac, S=(mS, eS), W2=(mW, eW),
                              chi=(mX, eX), chi_scaled=(mX / scale, eX / scale),
                              nontrivial_sector_frac=nontrivial_sectors,
                              worms_truncated=truncated,
                              trunc_frac=trunc_frac,
                              seconds=time.perf_counter() - t0)
        line = (f'{kappa:>6.2f} {acc_frac:>6.1%} {str(Uncertain(mS, eS)):>16} '
                f'{str(Uncertain(mW, eW)):>14} {str(Uncertain(mX, eX)):>14} '
                f'{str(Uncertain(mX / scale, eX / scale)):>14}')
        if worms > 0:
            mV, eV = b.estimate('VortexSusceptibility')
            results[kappa]['chiV'] = (mV, eV)
            results[kappa]['chiV_scaled'] = (mV / scaleV, eV / scaleV)
            if args.save_hist:
                results[kappa]['Vortex_Vortex_hist'] = histV
            line += f' {str(Uncertain(mV / scaleV, eV / scaleV)):>15}'
            line += f'  sect={nontrivial_sectors:.2f}'
        print(line, flush=True)

        if h5py is not None:
            # Write incrementally (one group per finished κ): a crash at κ_i
            # must not lose κ_{<i}.
            with h5py.File(args.h5, 'a') as f:
                name = f'kappa_{kappa}'
                if name in f:
                    del f[name]
                g = f.create_group(name)
                for k, v in results[kappa].items():
                    g[k] = np.asarray(v)
    return results


if __name__ == '__main__':
    results = main()
