"""The system under test: ``supervillain_tpu_torch.sample_fused_fleet``.

The one module of the benchmark that imports the program.  It builds the
action that a configuration names at the traffic's shape and calls the fleet
as a user does, with a ``progress`` hook, the program's public way to watch
records complete.
"""

from __future__ import annotations

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


def max_worm_moves(traffic):
    """The worm cap of every cell with worms: 64·N², passed to the fleet so
    that the program and the reference cap alike."""
    return 64 * traffic['L'] ** 2 if traffic['worms'] else None


def action(sv, config, traffic):
    return getattr(sv, config['action'])(sv.Lattice2D(traffic['L']), traffic['kappa'],
                                         W=traffic['W'])


def mesh(sv, traffic, device):
    """The chain mesh over every card where the traffic asks for one."""
    if traffic.get('mesh') != 'chains':
        return None
    from supervillain_tpu_torch.parallel import chain_mesh
    return chain_mesh(None if device == 'cuda' else [device] * traffic.get('shards', 1))


def fleet(sv, S, traffic, *, seed, steps, progress, mesh, device):
    """One call of the fleet: ``steps`` records from the cold start."""
    extra = {k: traffic[k] for k in ('interval_phi', 'interval_n', 'p_n') if k in traffic}
    return sv.sample_fused_fleet(S, chains=traffic['chains'], steps=steps, thin=traffic['thin'],
                                 seed=seed, worms=traffic['worms'],
                                 max_worm_moves=max_worm_moves(traffic), keep_fields=False,
                                 progress=progress, mesh=mesh, device=device, **extra)
