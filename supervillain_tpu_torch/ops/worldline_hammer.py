"""The fused Worldline Hammer: vortex, coexact and wrapping sweeps, then worms.

Counterpart of :func:`supervillain_tpu.ops.pallas_worldline_hammer.worldline_hammer_sweeps`.
On the TPU one launch keeps a chain in VMEM through both sections.  On a GPU
the chain state lives in device memory between launches anyway (one L=256
chain's m, v and residual take 1.25 MB, against a block's 227 KB of shared
memory), so the port composes the two kernels on one stream, as
:mod:`.hammer` does for the Villain action: the sweep kernel's passes, then
the worm kernel on the same tensors.  The reference's ``N % 128`` rule (a TPU
lane constraint) does not apply.
"""

from __future__ import annotations

from .worldline import worldline_sweeps
from .worldline_worm import worldline_worms


def worldline_hammer_sweeps(m, v, *, kappa, W, interval_v=1, interval_t=1, interval_w=1,
                            sweeps, worms=1, max_worm_moves=None, generator):
    """Run ``sweeps`` worldline local-update sweeps followed by ``worms``
    worldline worms per chain, at any W including ∞.

    Returns ``(m, v, accepted, inline)``: the per-chain inline ``ActionDensity``
    (1/2κ)Σ(m − δv/_W)²/Λ averaged over the sweeps (1 minus the registry
    observable of that name, in D=2), ``Spin_Spin`` (B, N, N),
    ``Worm_Length`` and ``Worm_Truncated``.  A CPU batch runs the plain
    versions, a CUDA batch the kernels."""
    if m.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'worldline_hammer_sweeps runs on the CPU or a CUDA device, not {m.device}')
    m, v, accepted, inline = worldline_sweeps(
        m, v, kappa=kappa, W=W, interval_v=interval_v, interval_t=interval_t,
        interval_w=interval_w, sweeps=sweeps, generator=generator)
    m, hist, length, truncated = worldline_worms(
        m, v, kappa=kappa, W=W, worms=worms, max_worm_moves=max_worm_moves, generator=generator)
    if m.device.type == 'cuda':
        worldline_hammer_sweeps.launches += 1
    inline = inline | {'Spin_Spin': hist, 'Worm_Length': length, 'Worm_Truncated': truncated}
    return m, v, accepted, inline


#: Calls that ran on the CUDA kernels (the CPU path never counts).
worldline_hammer_sweeps.launches = 0
