"""The system under test: ``supervillain_tpu_torch``'s two fleet drivers.

The one module of the benchmark that imports the program.  It builds the
action that a configuration names on a lattice of the configuration's D at
the traffic's shape, and calls the fleet that the traffic names as a user
does, with a ``progress`` hook, the program's public way to watch records
complete:

- ``sample_fused_fleet`` (the fused kernels, D=2), for every traffic without
  a ``"driver"`` key;
- ``sample_fleet`` with ``"driver": "sample_fleet"``: the action's
  ``Hammer(S, fleet=True)`` (its module of ``supervillain_tpu_torch.generators``),
  as ``examples/fleet-scan.py`` and ``Ensemble`` users run it, on any D.
"""

from __future__ import annotations

import importlib
import os

from .manifest import ROOT

#: The kernels' build directory: inside the checkout, at a fixed path, so that
#: a cell's later runs load the library that its first run built.
BUILD_DIR = ROOT / 'build' / 'perfbench' / 'kernels'


def load(device):
    """Import the program; on a card, build or load its kernels (set-up)."""
    os.environ['SUPERVILLAIN_TORCH_BUILD'] = str(BUILD_DIR)
    import supervillain_tpu_torch as sv
    if device == 'cuda':
        from supervillain_tpu_torch.ops import kernels
        kernels.library()
    return sv


def general(traffic):
    """Whether the traffic drives ``sample_fleet`` (else ``sample_fused_fleet``)."""
    return traffic.get('driver') == 'sample_fleet'


def max_worm_moves(traffic):
    """The worm cap of every fused cell with worms: 64·N², passed to the fleet
    so that the program and the reference cap alike (None without worms)."""
    return 64 * traffic['L'] ** 2 if traffic.get('worms') else None


def action(sv, config, traffic):
    """The configuration's action on a torus of side L in its D."""
    D, L = config['D'], traffic['L']
    lattice = sv.Lattice2D(L) if D == 2 else sv.Lattice(D, L)
    return getattr(sv, config['action'])(lattice, traffic['kappa'], W=traffic['W'])


def mesh(sv, traffic, device, chips):
    """The chain mesh over every card where the traffic asks for one; for
    ``sample_fleet`` otherwise a mesh of the cell's ``chips`` cards (of the one
    device off a card), since its default would span every visible card."""
    if traffic.get('mesh') == 'chains':
        from supervillain_tpu_torch.parallel import chain_mesh
        return chain_mesh(None if device == 'cuda' else [device] * traffic.get('shards', 1))
    if general(traffic):
        from supervillain_tpu_torch.parallel import ChainMesh
        return ChainMesh([f'cuda:{c}' for c in range(chips)] if device == 'cuda' else [device])
    return None


def hammer(S):
    """``Hammer(S, fleet=True)`` from the action's module of generators."""
    name = type(S).__name__.lower()
    module = importlib.import_module(f'supervillain_tpu_torch.generators.{name}')
    return module.Hammer(S, fleet=True)


def fleet(sv, S, traffic, *, seed, steps, progress, mesh, device):
    """One call of the fleet: ``steps`` records from the cold start."""
    if general(traffic):
        return sv.sample_fleet(S, hammer(S), chains=traffic['chains'], steps=steps,
                               thin=traffic['thin'], seed=seed, keep_fields=False,
                               progress=progress, mesh=mesh, device=device)
    extra = {k: traffic[k] for k in ('interval_phi', 'interval_n', 'p_n') if k in traffic}
    return sv.sample_fused_fleet(S, chains=traffic['chains'], steps=steps, thin=traffic['thin'],
                                 seed=seed, worms=traffic['worms'],
                                 max_worm_moves=max_worm_moves(traffic), keep_fields=False,
                                 progress=progress, mesh=mesh, device=device, **extra)
