#!/usr/bin/env python
"""The D=4 topological sector: the port of ``examples/d4-topology.py``.

A fleet of the 4-dimensional Villain model under the generic ``Hammer``
(Site + Link at W<∞ + Exact + Cohomology; the worm is D=2 only), then the
topological charge density Q = dn ∧ dn and its square beside the action
density and the winding, bootstrapped over the pooled chains.  Prints the JAX
script's columns: κ, ActionDensity, WindingSquared, ⟨Q²⟩·Λ and su/s (the sites
that Site and Exact update, 2·chains·Λ·thin·steps, over the fleet's seconds).

No hand kernel exists at D ≥ 3 (the TPU kernels are D=2 only), so every step
runs as PyTorch operations on the device chosen: the card (``--device cuda``,
the default) or the CPU (``--device cpu``).  At W=1 vortices are free and
⟨Q²⟩ > 0; at W=∞ dn = 0 exactly, so Q ≡ 0 and the script fails if it is not.
The defaults follow the device, as the JAX script's follow its backend: 8⁴,
32 chains, 60 records of 2 steps on the card; 3⁴, 4 chains, 10 records on the
CPU.  ``--h5`` (which needs h5py) stores the results.  ``main()`` returns them, and
run as a script it leaves them in the module's ``results``.
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
from supervillain_tpu_torch.device import resolve_device
from supervillain_tpu_torch.generators import villain as gv
from supervillain_tpu_torch.parallel import sample_fleet


def main():
    ap = sv.cli.ArgumentParser(description=__doc__)
    ap.add_argument('--N', type=int, default=None, help='8 on the card, 3 on the CPU')
    ap.add_argument('--chains', type=int, default=None, help='32 on the card, 4 on the CPU')
    ap.add_argument('--steps', type=int, default=None, help='60 on the card, 10 on the CPU')
    ap.add_argument('--thin', type=int, default=2)
    ap.add_argument('--cut', type=int, default=None, help='20 on the card, 4 on the CPU')
    ap.add_argument('--kappas', type=float, nargs='+', default=[0.2, 0.4, 0.6])
    ap.add_argument('--W', type=sv.cli.W, default=1)
    ap.add_argument('--bootstraps', type=int, default=100)
    ap.add_argument('--h5', type=str, default=None)
    ap.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()
    device = resolve_device(args.device)
    on_card = device.type == 'cuda'
    for name, card, cpu in (('N', 8, 3), ('chains', 32, 4), ('steps', 60, 10), ('cut', 20, 4)):
        if getattr(args, name) is None:
            setattr(args, name, card if on_card else cpu)
    h5py = sv.cli.h5py() if args.h5 else None

    D = 4
    L = sv.Lattice(D, args.N)
    print(f'# D=4 Villain, {args.N}^4, W={args.W}, {args.chains} chains × '
          f'{args.steps}×{args.thin} Hammer steps, device={device}')
    print(f'{"κ":>6} {"ActionDensity":>16} {"WindingSquared":>16} '
          f'{"⟨Q²⟩·Λ":>16} {"su/s":>10}')

    results = {}
    for kappa in args.kappas:
        S = sv.Villain(L, kappa, W=args.W)
        G = gv.Hammer(S)   # Site[+Link]+Exact+Cohomology (the worm is D=2 only)
        t0 = time.perf_counter()
        seed = int(kappa * 1000) + 7
        fleet = sample_fleet(S, G, chains=args.chains, steps=args.steps, thin=args.thin,
                             seed=seed, device=device)
        if on_card:
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        # su/s: the sites Site and Exact each update once a step.
        su = 2 * args.chains * L.sites * args.thin * args.steps
        pooled = fleet.pooled_ensemble(cut=args.cut)
        b = Bootstrap(pooled, draws=args.bootstraps, seed=seed)   # a run repeats itself
        mS, eS = b.estimate('ActionDensity')
        mW, eW = b.estimate('WindingSquared')
        q2 = np.asarray(pooled.TopologicalChargeDensitySquared) * L.sites
        mQ, eQ = q2.mean(), q2.std(ddof=1) / np.sqrt(len(q2))
        if args.W == float('inf') and abs(mQ) >= 1e-20:
            raise RuntimeError(f'Q must vanish identically at W=inf (dn=0), got ⟨Q²⟩·Λ = {mQ}')
        results[kappa] = dict(S=(mS, eS), W2=(mW, eW), Q2V=(float(mQ), float(eQ)),
                              su_per_s=su / seconds, seconds=seconds)
        print(f'{kappa:>6.2f} {str(Uncertain(mS, eS)):>16} '
              f'{str(Uncertain(mW, eW)):>16} {str(Uncertain(mQ, eQ)):>16} '
              f'{su / seconds:>10.3g}', flush=True)

    if h5py is not None:
        with h5py.File(args.h5, 'w') as f:
            for kappa, res in results.items():
                g = f.create_group(f'kappa_{kappa}')
                for k, v in res.items():
                    g[k] = np.asarray(v)
    return results


if __name__ == '__main__':
    results = main()
