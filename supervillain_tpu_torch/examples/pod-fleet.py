#!/usr/bin/env python
"""The many-chain workload: 10,240 independent L=64 chains at κ=0.74 as one batch
on one card, or sharded over the cards with ``--mesh``, with autocorrelation
and bootstrap analysis and, with ``--h5`` (which needs h5py), HDF5 output: the
port of ``examples/pod-fleet.py``.

``sample_fused_fleet`` launches the fused neighborhood sweep over the whole
batch (or each shard) every record; the inline observables bring two scalars
per chain per record to the host.  Runs on the card (``--device cuda``, the
default) or, with ``--device cpu``, through the plain PyTorch version, at the
size asked for.  ``--mesh`` shards the chains over :func:`chain_mesh`, every
card (or, in a ``torchrun`` group, every process's card); the result does not
depend on it.  The JAX script's chain packing (``--cpp``) is not ported.
``main()`` returns the fleet, the estimates and the rate.
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

import supervillain_tpu_torch as sv
from supervillain_tpu_torch.analysis import Bootstrap, Uncertain, autocorrelation_time
from supervillain_tpu_torch.configurations import Configurations
from supervillain_tpu_torch.ensemble import Ensemble
from supervillain_tpu_torch.parallel import chain_mesh, sample_fused_fleet


def main():
    ap = sv.cli.ArgumentParser(description=__doc__)
    ap.add_argument('--L', type=int, default=64)
    ap.add_argument('--chains', type=int, default=10240)
    ap.add_argument('--kappa', type=float, default=0.74)
    ap.add_argument('--therm', type=int, default=2048)
    ap.add_argument('--steps', type=int, default=128)
    ap.add_argument('--thin', type=int, default=16)
    ap.add_argument('--h5', type=str, default=None, help='write the fleet here (needs h5py)')
    ap.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
    ap.add_argument('--mesh', action='store_true', help='shard the chains over every card')
    args = ap.parse_args()

    h5py = sv.cli.h5py() if args.h5 else None
    S = sv.Villain(sv.Lattice2D(args.L), args.kappa, W=1)
    mesh = chain_mesh(None if args.device == 'cuda' else [args.device]) if args.mesh else None

    t0 = time.perf_counter()
    # Thermalize inside the first records: run therm as extra leading records
    # and cut them in the analysis (keeps the sampling a single loop).
    lead = max(1, args.therm // args.thin)
    fleet = sample_fused_fleet(
        S, chains=args.chains, steps=lead + args.steps, thin=args.thin,
        seed=20260821, interval_phi=0.7, p_n=0.05, keep_fields=False, mesh=mesh,
        device=args.device)
    seconds = time.perf_counter() - t0
    su = args.chains * S.Lattice.sites * args.thin * (lead + args.steps)

    # Autocorrelation of the per-chain ActionDensity series (the records are
    # `thin` sweeps apart; τ is reported in kept-record units), over up to 32
    # chains spread across the batch.
    cols = fleet.columns['ActionDensity'][lead:]           # (steps, chains)
    taus = [float(autocorrelation_time(cols[:, g])) for g in range(0, cols.shape[1],
                                                                   max(1, cols.shape[1] // 32))]
    tau = float(np.mean(taus))

    # Bootstrap over independent chains of their time-means.
    e = Ensemble(S).from_configurations(Configurations({
        'ActionDensity': cols.mean(axis=0),
        'WindingSquared': fleet.columns['WindingSquared'][lead:].mean(axis=0),
    }), device=args.device)
    b = Bootstrap(e, draws=200)
    mS, eS = b.estimate('ActionDensity')
    mW, eW = b.estimate('WindingSquared')

    where = f'one {args.device} device' if mesh is None else f'{mesh.size} shards ({mesh})'
    print(f'# pod-fleet: {args.chains} chains, L={args.L}, κ={args.kappa}, {where}')
    print(f'records {args.steps}×thin={args.thin} after {lead} lead records; '
          f'{seconds:.1f} s total = {su / seconds:.3g} site-updates/s')
    print(f'ActionDensity  = {Uncertain(mS, eS)}')
    print(f'WindingSquared = {Uncertain(mW, eW)}')
    print(f'autocorrelation time ≈ {tau:.2f} kept records '
          f'({tau * args.thin:.0f} sweeps)')

    if h5py is not None:
        with h5py.File(args.h5, 'w') as f:
            fleet.to_h5(f.create_group('fleet'))
        print(f'wrote {args.h5}')
    return {'fleet': fleet, 'ActionDensity': (mS, eS), 'WindingSquared': (mW, eW),
            'seconds': seconds, 'site_updates_per_second': su / seconds, 'tau': tau}


if __name__ == '__main__':
    result = main()
