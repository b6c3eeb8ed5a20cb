#!/usr/bin/env python
"""The W=∞ self-dual duality check at production scale on the fused kernels: the
port of ``examples/self-dual-fused.py``.

``no-vortices.py`` runs the same physics at small N on the eager generators;
this script runs it at L=256 on the fused Hammers: the Villain side on z-mode
neighborhood sweeps (compound (Δφ, Δz), dn = 0 exact) then worms, the
Worldline side on the float-v vortex/coexact/wrapping sweeps then worms.  At
the self-dual coupling κ = 1/2π the two formulations' action densities must
agree within Monte-Carlo error.

Both sides are critical (massless spin waves), so thermalization is τ ~ L²
sweeps of local updates; the defaults thermalize 8·L² sweeps and record
samples L²/8 sweeps apart.  Runs on the card (``--device cuda``, the default;
the kernels take any L the card holds, odd or even) or, with ``--device
cpu``, through the plain PyTorch versions, at the size asked for.  ``main()``
returns the two estimates and the pull.
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
from supervillain_tpu_torch.device import field_dtypes, resolve_device
from supervillain_tpu_torch.ops import calculus as calc
from supervillain_tpu_torch.ops.hammer import hammer_sweeps
from supervillain_tpu_torch.ops.sweep import neighborhood_sweeps
from supervillain_tpu_torch.ops.worldline import action_density, worldline_sweeps
from supervillain_tpu_torch.ops.worldline_hammer import worldline_hammer_sweeps

WINF = float('inf')


def main():
    ap = sv.cli.ArgumentParser(description=__doc__)
    ap.add_argument('--L', type=int, default=256)
    ap.add_argument('--chains', type=int, default=16)
    ap.add_argument('--kappa', type=float, default=0.5 / np.pi)
    ap.add_argument('--therm-factor', type=int, default=8,
                    help='thermalization sweeps = factor * L^2')
    ap.add_argument('--records', type=int, default=24)
    ap.add_argument('--worms', type=int, default=1,
                    help='worms per thin interval (both sides run their W=∞ '
                         'Hammers: closed worms preserve the constraints '
                         'exactly while sampling the integer winding sectors '
                         'the bare sweeps freeze).  0 = sweeps only.')
    ap.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()

    device = resolve_device(args.device)
    fdt, idt = field_dtypes(device)
    N, B, kappa = args.L, args.chains, args.kappa
    therm = args.therm_factor * N * N
    thin = max(64, N * N // 8)
    launch_cap = 4096
    worms = args.worms
    rng = torch.Generator(device=device).manual_seed(20260821)

    def calls(sweeps):
        """Split ``sweeps`` into calls of at most ``launch_cap`` sweeps."""
        while sweeps > 0:
            c = min(sweeps, launch_cap)
            yield c
            sweeps -= c

    def worm_count(sweeps):
        return max(1, (worms * sweeps) // thin)

    # ---- Villain side: z-mode fused sweeps (+ worms: the W=∞ Hammer) ------
    def v_launch(phi, n, sweeps):
        common = dict(kappa=kappa, W=WINF, interval_phi=1.5, interval_n=1, sweeps=sweeps,
                      generator=rng)
        if worms > 0:
            phi, n, _, inline = hammer_sweeps(phi, n, worms=worm_count(sweeps),
                                              max_worm_moves=64 * N * N, **common)
        else:
            phi, n, _, inline = neighborhood_sweeps(phi, n, **common)
        return phi, n, inline

    t0 = time.perf_counter()
    phi = torch.zeros((B, 1, N, N), dtype=fdt, device=device)
    n = torch.zeros((B, 2, N, N), dtype=idt, device=device)
    for c in calls(therm):
        phi, n, _ = v_launch(phi, n, c)
    v_ad = np.empty((args.records, B))
    for r in range(args.records):
        for c in calls(max(0, thin - launch_cap)):
            phi, n, _ = v_launch(phi, n, c)
        phi, n, inline = v_launch(phi, n, min(thin, launch_cap))
        v_ad[r] = inline['ActionDensity'].cpu().numpy()
    # The inline WindingSquared doubles as an exact constraint check: dn = 0.
    if float(inline['WindingSquared'].abs().max()) != 0.0:
        raise RuntimeError('the W=∞ Villain chains left dn = 0')
    v_secs = time.perf_counter() - t0

    # ---- Worldline side: float-v fused local updates (+ worms: Hammer) ----
    L2d = sv.Lattice2D(N)

    def w_launch(m, v, sweeps):
        common = dict(kappa=kappa, W=WINF, interval_v=1, interval_t=1, interval_w=1,
                      sweeps=sweeps, generator=rng)
        if worms > 0:
            m, v, _, _ = worldline_hammer_sweeps(m, v, worms=worm_count(sweeps),
                                                 max_worm_moves=64 * N * N, **common)
        else:
            m, v, _, _ = worldline_sweeps(m, v, **common)
        return m, v

    t0 = time.perf_counter()
    m = torch.zeros((B, 2, N, N), dtype=idt, device=device)
    v = torch.zeros((B, 1, N, N), dtype=fdt, device=device)
    for c in calls(therm):
        m, v = w_launch(m, v, c)
    w_ad = np.empty((args.records, B))
    for r in range(args.records):
        for c in calls(thin):
            m, v = w_launch(m, v, c)
        # ActionDensity = κ∂_κS/Λ = 1 − (1/2κ)Σ(m − δv/2π)²/Λ  (W=∞: _W=2π).
        w_ad[r] = (1.0 - action_density(m, v, kappa, WINF)).cpu().numpy()
    # δm = 0 exactly on every chain.
    if int(calc.delta(L2d, 1, m).abs().max()) != 0:
        raise RuntimeError('the W=∞ Worldline chains left δm = 0')
    w_secs = time.perf_counter() - t0

    # ---- Duality comparison (per-chain means; chains independent) ---------
    def estimate(cols):
        per_chain = cols.mean(axis=0)
        return per_chain.mean(), per_chain.std(ddof=1) / np.sqrt(len(per_chain))

    mv, ev = estimate(v_ad)
    mw, ew = estimate(w_ad)
    pull = (mv - mw) / np.hypot(ev, ew)
    kappa_str = '1/2π' if abs(kappa - 0.5 / np.pi) < 1e-12 else f'{kappa}'
    print(f'# self-dual W=∞ κ={kappa_str} L={N} chains={B} therm={therm} '
          f'records={args.records}×thin={thin}')
    print(f'Villain   (z-mode fused)  ActionDensity = {Uncertain(mv, ev)}   [{v_secs:.0f} s]')
    print(f'Worldline (fused W=∞)     ActionDensity = {Uncertain(mw, ew)}   [{w_secs:.0f} s]')
    print(f'duality pull: {pull:+.2f}σ')
    return {'villain': (mv, ev), 'worldline': (mw, ew), 'pull': pull,
            'seconds': (v_secs, w_secs)}


if __name__ == '__main__':
    result = main()
