"""Sampling a batch of Villain chains with the fused kernels.

PyTorch counterpart of
:func:`supervillain_tpu.parallel.fused_fleet.sample_fused_fleet` for the
Villain action.  The chain batch is the leading tensor axis on one device;
every call advances all chains ``thin`` sweeps (and, with ``worms > 0``, that
many classic worms) and returns inline observables measured in the call.  On a
GPU the calls run the CUDA kernels; on the CPU the plain versions.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..models import Villain
from ..models.villain import field_dtypes
from ..ops.hammer import hammer_sweeps
from ..ops.sweep import neighborhood_sweeps
from .fleet import Fleet

#: Truncated-worm fraction above which inline worm histograms should not be
#: used quantitatively (the short-separation bias scales with this fraction).
TRUNCATION_BUDGET = 1e-3


def check_truncation_budget(truncated, total_worms, *, budget=TRUNCATION_BUDGET, context=''):
    """Warn when the truncated fraction of worms exceeds ``budget``; return it.

    Capped worms roll back exactly (the sampled distribution is unbiased) but
    their histogram tallies are kept, so the inline Vortex_Vortex correlator
    carries a short-separation bias proportional to the truncated fraction."""
    total_worms = max(1, int(total_worms))
    frac = float(truncated) / total_worms
    if frac > budget:
        warnings.warn(
            f'{context}{float(truncated):.0f}/{total_worms} worms truncated '
            f'(fraction {frac:.2e} > {budget:g}) — inline worm histograms '
            f'carry short-separation bias at this point; raise '
            f'max_worm_moves or exclude the inline correlator from fits.',
            stacklevel=2)
    return frac


def sample_fused_fleet(action, *, chains, steps, thin=10, seed=0, interval_phi=np.pi,
                       interval_n=1, p_n=None, keep_fields=False, progress=None, worms=0,
                       max_worm_moves='auto', device='cpu'):
    """Sample ``chains`` Villain chains for ``steps`` kept records, each separated
    by ``thin`` fused sweeps, on ``device``.

    Returns a :class:`Fleet` whose columns are the inline observables (and the
    fields, if ``keep_fields``).  ``worms > 0`` runs the fused Hammer: every
    record's sweeps are followed by that many classic worms per chain, adding
    ``Vortex_Vortex``, ``Worm_Length`` and ``Worm_Truncated`` columns.  Worms are
    capped at 64·N² moves by default (exact rollback at W≠1); pass
    ``max_worm_moves=None`` for unbounded worms.  ``seed`` seeds the host
    ``torch.Generator`` that draws every call's randomness."""
    if not isinstance(action, Villain):
        raise ValueError('sample_fused_fleet drives the Villain action')
    L = action.Lattice
    N = L.N
    fdt, idt = field_dtypes(device)
    phi = torch.zeros((chains, 1, N, N), dtype=fdt, device=device)
    n = torch.zeros((chains, 2, N, N), dtype=idt, device=device)

    if max_worm_moves == 'auto':
        max_worm_moves = 64 * N * N if worms > 0 else None
    W = action.W
    common = dict(kappa=action.kappa, W=W, interval_phi=float(interval_phi),
                  interval_n=int(interval_n), sweeps=thin,
                  p_n=None if p_n is None else float(p_n))

    rng = torch.Generator(device=device).manual_seed(int(seed))
    columns = None
    total_accepted = 0.0
    iterator = range(steps) if progress is None else progress(range(steps))
    for i in iterator:
        if worms > 0:
            phi, n, acc, inline = hammer_sweeps(phi, n, worms=int(worms),
                                                max_worm_moves=max_worm_moves,
                                                generator=rng, **common)
        else:
            phi, n, acc, inline = neighborhood_sweeps(phi, n, generator=rng, **common)
        record = {k: v.cpu().numpy() for k, v in inline.items()}
        if keep_fields:
            record['phi'] = phi.cpu().numpy()
            record['n'] = n.cpu().numpy()
        total_accepted += float(acc.sum())
        if columns is None:
            columns = {k: np.empty((steps,) + v.shape, dtype=v.dtype) for k, v in record.items()}
        for k, v in record.items():
            columns[k][i] = v

    if columns is not None and 'Worm_Truncated' in columns:
        check_truncation_budget(columns['Worm_Truncated'].sum(), worms * steps * chains,
                                context='sample_fused_fleet: ')

    proposals = chains * L.sites * thin * steps
    stats = {'NeighborhoodUpdate': {
        'accepted': total_accepted,
        'proposed': float(proposals),
        'acceptance': total_accepted / proposals,
        'sweeps': float(thin * steps),
    }}
    final = {'phi': phi.cpu().numpy(), 'n': n.cpu().numpy()}
    index = thin * (1 + np.arange(steps))
    return Fleet(action, columns, stats, final, index)
