#!/usr/bin/env python
"""The W=∞ line of fixed points: continuously varying critical exponent, the port
of ``examples/winf-line.py``.

With vortices forbidden (dn = 0 exactly) the model is a free massless compact
boson at EVERY κ — a line of fixed points with continuously varying spin
exponent.  For the Villain normalization S = (κ/2)Σ(dφ − 2πn)² the Gaussian
correlator gives the exact power law

    ⟨e^{iφ(x)} e^{-iφ(0)}⟩ ~ r^{-η(κ)},   η(κ) = 1/(2πκ)

with no BKT-style logarithmic corrections (there is no marginal operator —
nothing to run).  So the two-volume effective exponent of the spin
susceptibility must land on 1/(2πκ) at every κ — measured here at several
volumes per κ on the fused W=∞ Hammer (z-mode sweeps then worms; worms keep the
winding sectors formally ergodic).

Per chain, χ_S = Σ_r C(r)/C(0) of C = correlation(e^{iφ}, e^{iφ}) is computed
on the chains' device; only the (chains,) column comes to the host.  Runs on
the card (``--device cuda``, the default; the kernels take any L, odd or even)
or, with ``--device cpu``, through the plain PyTorch versions, at the sizes
asked for.
``main()`` returns ``{κ: {'chi': {L: (mean, error)}, 'eta': [(η_eff, error)
for each pair of consecutive volumes]}}``.
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
from supervillain_tpu_torch.analysis import Uncertain
from supervillain_tpu_torch.analysis.scaling import (effective_exponent,
                                                     effective_exponent_error)
from supervillain_tpu_torch.device import field_dtypes, resolve_device
from supervillain_tpu_torch.ops.hammer import hammer_sweeps


def main():
    ap = sv.cli.ArgumentParser(description=__doc__)
    ap.add_argument('--Ls', type=int, nargs='+', default=[64, 128, 256])
    ap.add_argument('--kappas', type=float, nargs='+',
                    default=[0.5 / np.pi, 1.0 / np.pi, 2.0 / np.pi])
    ap.add_argument('--records', type=int, default=24)
    ap.add_argument('--therm-factor', type=int, default=8)
    ap.add_argument('--chains', type=int, default=None,
                    help='chains per volume (default max(16, 4096 // L))')
    ap.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()

    device = resolve_device(args.device)
    fdt, idt = field_dtypes(device)
    rng = torch.Generator(device=device).manual_seed(20260822)

    def chi_at(N, kappa):
        B = args.chains or max(16, 4096 // N)
        L2 = sv.Lattice2D(N)
        therm = args.therm_factor * N * N
        thin = max(64, N * N // 8)

        def launch(phi, n, sweeps):
            return hammer_sweeps(
                phi, n, kappa=kappa, W=float('inf'), interval_phi=1.5, interval_n=1,
                sweeps=sweeps, worms=max(1, sweeps // thin), max_worm_moves=64 * N * N,
                generator=rng)

        def spin_chi(phi):
            spin = torch.polar(torch.ones_like(phi[:, 0]), phi[:, 0])
            corr = L2.correlation(spin, spin).real
            return (corr.sum(dim=(1, 2)) / corr[:, 0, 0]).cpu().numpy()

        phi = torch.zeros((B, 1, N, N), dtype=fdt, device=device)
        n = torch.zeros((B, 2, N, N), dtype=idt, device=device)
        remaining = therm
        while remaining > 0:
            c = min(remaining, 4096)
            phi, n, _, _ = launch(phi, n, c)
            remaining -= c
        chis = np.empty((args.records, B))
        for r in range(args.records):
            phi, n, _, _ = launch(phi, n, thin)
            chis[r] = spin_chi(phi)
        per_chain = chis.mean(axis=0)
        return per_chain.mean(), per_chain.std(ddof=1) / np.sqrt(B)

    print('# W=inf line of fixed points: eta(kappa) = 1/(2 pi kappa) exactly '
          '(free boson, no vortices, no log corrections)')
    print(f'{"κ":>8} {"η exact":>8} ' +
          ' '.join(f'{f"χ_S(L={L})":>16}' for L in args.Ls) +
          '  η_eff per volume pair')
    results = {}
    for kappa in args.kappas:
        t0 = time.perf_counter()
        vals = {L: chi_at(L, kappa) for L in args.Ls}
        eta_exact = 1.0 / (2 * np.pi * kappa)
        cells = ' '.join(f'{str(Uncertain(*vals[L])):>16}' for L in args.Ls)
        etas = []
        for La, Lb in zip(args.Ls[:-1], args.Ls[1:]):
            (ma, ea), (mb, eb) = vals[La], vals[Lb]
            _, eta = effective_exponent(La, ma, Lb, mb)
            etas.append((eta, effective_exponent_error(La, ma, ea, Lb, mb, eb)))
        print(f'{kappa:>8.4f} {eta_exact:>8.3f} {cells}  '
              + ' '.join(f'{eta:.3f}({err:.3f})' for eta, err in etas)
              + f'   [{time.perf_counter() - t0:.0f} s]', flush=True)
        results[kappa] = {'chi': vals, 'eta': etas}
    return results


if __name__ == '__main__':
    results = main()
