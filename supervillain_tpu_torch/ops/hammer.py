"""The fused Villain Hammer: neighborhood sweeps, then classic worms.

Counterpart of :func:`supervillain_tpu.ops.pallas_hammer.hammer_sweeps`.  On
the TPU one launch keeps a chain in VMEM through both sections.  The port
composes the two kernels on one stream: the sweep kernel (which holds a chain
of N <= 304 in a thread-block cluster's shared memory for its whole call),
then the worm kernel on the fields it wrote to device memory.  Keeping the
chain on chip through the worm as well is a later performance question.
"""

from __future__ import annotations

from .sweep import neighborhood_sweeps
from .worm import classic_worms


def hammer_sweeps(phi, n, *, kappa, W, interval_phi, interval_n, sweeps, worms=1,
                  p_n=None, max_worm_moves=None, generator):
    """Run ``sweeps`` neighborhood sweeps followed by ``worms`` classic worms
    per chain.  ``W = inf`` runs z-mode sweeps with the worms kept: closed worms
    preserve dn = 0 exactly while wrapping worms sample the winding sectors
    z-mode sweeps cannot reach.

    Returns ``(phi, n, accepted, inline)`` with the per-chain inline
    ``ActionDensity`` and ``WindingSquared`` (averaged over the sweeps),
    ``Vortex_Vortex`` (B, N, N), ``Worm_Length`` and ``Worm_Truncated``.
    A CPU batch runs the plain versions, a CUDA batch the kernels."""
    if phi.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'hammer_sweeps runs on the CPU or a CUDA device, not {phi.device}')
    phi, n, accepted, inline = neighborhood_sweeps(
        phi, n, kappa=kappa, W=W, interval_phi=interval_phi, interval_n=interval_n,
        sweeps=sweeps, p_n=p_n, generator=generator)
    n, hist, length, truncated = classic_worms(
        phi, n, kappa=kappa, W=W, worms=worms, max_worm_moves=max_worm_moves,
        generator=generator)
    if phi.device.type == 'cuda':
        hammer_sweeps.launches += 1
    inline = inline | {'Vortex_Vortex': hist, 'Worm_Length': length,
                       'Worm_Truncated': truncated}
    return phi, n, accepted, inline


#: Calls that ran on the CUDA kernels (the CPU path never counts).
hammer_sweeps.launches = 0
