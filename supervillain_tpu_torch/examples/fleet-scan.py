#!/usr/bin/env python
"""A fleet of independent chains scanning κ across the BKT transition with inline
observables and pooled bootstrap analysis, and HDF5 output with ``--h5`` (which
needs h5py): the port of ``examples/fleet-scan.py``.

Every step of ``Hammer(S, fleet=True)`` runs over the whole batch of chains, on
the card (``--device cuda``, the default) or, with ``--device cpu``, through
the plain PyTorch versions.  ``sample_fleet`` shards the chains over every
card where there is more than one, as the JAX script does; ``--mesh`` asks for
:func:`chain_mesh` on one card too.  The result does not depend on it.
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

import supervillain_tpu_torch as sv
from supervillain_tpu_torch.analysis import Bootstrap, Uncertain
from supervillain_tpu_torch.generators import villain as gvillain
from supervillain_tpu_torch.parallel import chain_mesh, sample_fleet

parser = sv.cli.ArgumentParser(description='Multi-chain κ scan.')
parser.add_argument('--N', type=int, default=32)
parser.add_argument('--W', type=sv.cli.W, default=1)
parser.add_argument('--chains', type=int, default=64)
parser.add_argument('--steps', type=int, default=100)
parser.add_argument('--thin', type=int, default=4)
parser.add_argument('--cut', type=int, default=25)
parser.add_argument('--kappas', nargs='*', type=float, default=(0.5, 0.74, 1.0))
parser.add_argument('--h5', default='')
parser.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
parser.add_argument('--mesh', action='store_true', help='shard the chains over every card')
args = parser.parse_args()

h5py = sv.cli.h5py() if args.h5 else None
L = sv.Lattice2D(args.N)
mesh = chain_mesh(None if args.device == 'cuda' else [args.device]) if args.mesh else None

where = args.device if mesh is None else f'{mesh.size} shards ({mesh})'
print(f'{where}; {args.chains} chains of {args.steps}x{args.thin} sweeps at N={args.N}')
print(f'{"kappa":>8s} {"ActionDensity":>16s} {"WindingSquared":>18s} {"acc(site)":>10s}')

results = {}
for kappa in args.kappas:
    S = sv.Villain(L, kappa, W=args.W)
    # fleet=True composes bounded worms (ChunkedWorm at W=1, max_moves-capped
    # ClassicWorm at W>1) so no step waits on the slowest chain's worm.
    G = gvillain.Hammer(S, fleet=True)
    fleet = sample_fleet(S, G, chains=args.chains, steps=args.steps, thin=args.thin,
                         seed=int(kappa * 1000), mesh=mesh, device=args.device)
    pooled = fleet.pooled_ensemble(cut=args.cut)
    b = Bootstrap(pooled, draws=100)
    sa = fleet.stats['SiteUpdate']
    results[kappa] = (fleet, b)
    print(f'{kappa:8.3f} {str(Uncertain(*b.estimate("ActionDensity"))):>16s} '
          f'{str(Uncertain(*b.estimate("WindingSquared"))):>18s} '
          f'{float(sa["accepted"]) / float(sa["proposed"]):>10.4f}')

if h5py is not None:
    with h5py.File(args.h5, 'w') as f:
        for kappa, (fleet, b) in results.items():
            fleet.to_h5(f.create_group(f'kappa={kappa}'))
    print(f'wrote {args.h5}')
