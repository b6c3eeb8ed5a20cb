"""Sampling a batch of chains with the fused kernels.

PyTorch counterpart of
:func:`supervillain_tpu.parallel.fused_fleet.sample_fused_fleet`, for both
formulations: a Villain action drives the neighborhood / Hammer kernels over
(φ, n), a Worldline action the vortex+coexact+wrapping / worldline-Hammer
kernels over (m, v).  The chain batch is the leading tensor axis on one
device; every call advances all chains ``thin`` sweeps (and, with
``worms > 0``, that many worms) and returns inline observables measured in the
call.  On a GPU the calls run the CUDA kernels; on the CPU the plain versions.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..device import field_dtypes, resolve_device
from ..models import Villain, Worldline
from ..ops.hammer import hammer_sweeps
from ..ops.sweep import neighborhood_sweeps
from ..ops.worldline import action_density, worldline_sweeps
from ..ops.worldline_hammer import worldline_hammer_sweeps
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


def _villain_launch(action, *, thin, interval_phi, interval_n, p_n, worms, max_worm_moves):
    """(phi, n, generator) -> (phi, n, accepted, inline) for one record."""
    common = dict(kappa=action.kappa, W=action.W, interval_phi=float(interval_phi),
                  interval_n=int(interval_n), sweeps=thin,
                  p_n=None if p_n is None else float(p_n))
    if worms > 0:
        return lambda phi, n, rng: hammer_sweeps(phi, n, worms=int(worms),
                                                 max_worm_moves=max_worm_moves,
                                                 generator=rng, **common)
    return lambda phi, n, rng: neighborhood_sweeps(phi, n, generator=rng, **common)


def _worldline_launch(action, *, thin, worms, max_worm_moves):
    """(m, v, generator) -> (m, v, accepted, inline) for one record.  Without
    worms the sweep returns no inline column the fleet keeps: ActionDensity,
    (1/2κ)Σu²/Λ, is measured on the kept state after the call, as the JAX
    package does."""
    common = dict(kappa=action.kappa, W=action.W, sweeps=thin)
    if worms > 0:
        return lambda m, v, rng: worldline_hammer_sweeps(m, v, worms=int(worms),
                                                         max_worm_moves=max_worm_moves,
                                                         generator=rng, **common)

    def launch(m, v, rng):
        m, v, accepted, _ = worldline_sweeps(m, v, generator=rng, **common)
        return m, v, accepted, {'ActionDensity': action_density(m, v, action.kappa, action.W)}
    return launch


def sample_fused_fleet(action, *, chains, steps, thin=10, seed=0, interval_phi=np.pi,
                       interval_n=1, p_n=None, keep_fields=False, progress=None, worms=0,
                       max_worm_moves='auto', device='cuda'):
    """Sample ``chains`` chains of a Villain or Worldline action for ``steps``
    kept records, each separated by ``thin`` fused sweeps, on ``device`` (the
    card unless ``device='cpu'``).

    Returns a :class:`Fleet` whose columns are the inline observables (and the
    fields, if ``keep_fields``).  ``worms > 0`` runs the fused Hammer: every
    record's sweeps are followed by that many worms per chain, adding the worm
    histogram (``Vortex_Vortex`` for Villain, ``Spin_Spin`` for Worldline),
    ``Worm_Length`` and ``Worm_Truncated`` columns.  Worms are capped at 64·N²
    moves by default (exact rollback of an unclosed worm where it would break
    the constraint); pass ``max_worm_moves=None`` for unbounded worms.  A
    Worldline fleet's inline ``ActionDensity`` is the kernels'
    (1/2κ)Σ(m − δv/_W)²/Λ, 1 minus the registry observable of that name in D=2;
    ``interval_phi``, ``interval_n`` and ``p_n`` are Villain options.  ``seed``
    seeds the ``torch.Generator`` that draws every call's randomness."""
    worldline = isinstance(action, Worldline)
    if not (worldline or isinstance(action, Villain)):
        raise ValueError('sample_fused_fleet drives a Villain or a Worldline action')
    device = resolve_device(device)
    L = action.Lattice
    N = L.N
    fdt, idt = field_dtypes(device)
    if max_worm_moves == 'auto':
        max_worm_moves = 64 * N * N if worms > 0 else None
    if worldline:
        names = ('m', 'v')
        a = torch.zeros((chains, 2, N, N), dtype=idt, device=device)
        b = torch.zeros((chains, 1, N, N), dtype=fdt if action.W == float('inf') else idt,
                        device=device)
        launch = _worldline_launch(action, thin=thin, worms=worms, max_worm_moves=max_worm_moves)
        per_sweep = 2 * L.sites + 2 * N
        tag = 'WorldlineLocalUpdates'
    else:
        names = ('phi', 'n')
        a = torch.zeros((chains, 1, N, N), dtype=fdt, device=device)
        b = torch.zeros((chains, 2, N, N), dtype=idt, device=device)
        launch = _villain_launch(action, thin=thin, interval_phi=interval_phi,
                                 interval_n=interval_n, p_n=p_n, worms=worms,
                                 max_worm_moves=max_worm_moves)
        per_sweep = L.sites
        tag = 'NeighborhoodUpdate'

    rng = torch.Generator(device=device).manual_seed(int(seed))
    columns = None
    total_accepted = 0.0
    iterator = range(steps) if progress is None else progress(range(steps))
    for i in iterator:
        a, b, acc, inline = launch(a, b, rng)
        record = {k: v.cpu().numpy() for k, v in inline.items()}
        if keep_fields:
            record[names[0]] = a.cpu().numpy()
            record[names[1]] = b.cpu().numpy()
        total_accepted += float(acc.sum())
        if columns is None:
            columns = {k: np.empty((steps,) + v.shape, dtype=v.dtype) for k, v in record.items()}
        for k, v in record.items():
            columns[k][i] = v

    if columns is not None and 'Worm_Truncated' in columns:
        check_truncation_budget(columns['Worm_Truncated'].sum(), worms * steps * chains,
                                context='sample_fused_fleet: ')

    proposals = chains * per_sweep * thin * steps
    stats = {tag: {
        'accepted': total_accepted,
        'proposed': float(proposals),
        'acceptance': total_accepted / proposals,
        'sweeps': float(thin * steps),
    }}
    final = {names[0]: a.cpu().numpy(), names[1]: b.cpu().numpy()}
    index = thin * (1 + np.arange(steps))
    return Fleet(action, columns, stats, final, index, device=device)
