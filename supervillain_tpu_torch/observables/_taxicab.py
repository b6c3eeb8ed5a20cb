"""Taxicab-path gather tables for the defect-reweighting correlators: a NumPy
copy of :mod:`supervillain_tpu.observables._taxicab`.

The Worldline ``Spin_Spin`` and Villain ``Vortex_Vortex`` measurements reweight by
the action change of a path-shaped field offset.  Per displacement the path is
the taxicab route: the full time separation first, then the full space
separation (D=2 only).  The padded per-displacement gather tables (direction,
offset, sign) are built once per lattice on the host; the measurement is a
batched gather and reduction over them, chunked over displacement rows
(:func:`taxicab_sums`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

#: Elements of one batched gather of :func:`taxicab_mean`.
GATHER_BUDGET = 1 << 24


@lru_cache(maxsize=None)
def spin_tables(D, N):
    """Padded path tables for the Worldline Spin_Spin taxicab measurement.

    Returns (dirs, offs, signs, lengths) with shapes (N, N, Lmax), (N, N, Lmax, 2),
    (N, N, Lmax), (N, N); displacement (i, j) labels Δ = (coord_1d[i], coord_1d[j]).
    Tracing along a link counts +1, against it −1.
    """
    if D != 2:
        raise NotImplementedError('Taxicab paths are implemented for D=2 only.')
    from ..ops.lattice import fft_coordinates
    coord = fft_coordinates(N)
    Lmax = 2 * (N // 2)
    dirs = np.zeros((N, N, Lmax), dtype=np.int32)
    offs = np.zeros((N, N, Lmax, 2), dtype=np.int32)
    signs = np.zeros((N, N, Lmax), dtype=np.int32)
    lengths = np.zeros((N, N), dtype=np.int32)

    for i in range(N):
        dt = int(coord[i])
        for j in range(N):
            dx = int(coord[j])
            T, X = abs(dt), abs(dx)
            length = T + X
            lengths[i, j] = length
            steps = []
            if dt > 0:
                # Temporal links at (0,0), (1,0), ..., (dt-1, 0), traced along (+).
                steps += [(0, (t, 0), +1) for t in range(dt)]
            elif dt < 0:
                # Traced against: links at (-1,0), ..., (dt, 0).
                steps += [(0, (t, 0), -1) for t in range(-1, dt - 1, -1)]
            if dx > 0:
                steps += [(1, (dt, x), +1) for x in range(dx)]
            elif dx < 0:
                steps += [(1, (dt, x), -1) for x in range(-1, dx - 1, -1)]
            for s, (d, (ot, ox), sg) in enumerate(steps):
                dirs[i, j, s] = d
                offs[i, j, s] = (ot % N, ox % N)
                signs[i, j, s] = sg
    return dirs, offs, signs, lengths


@lru_cache(maxsize=None)
def vortex_tables(D, N):
    """Padded dual-lattice path tables for the Villain Vortex_Vortex measurement.

    The path traces on the dual lattice from ★y to ★x; its Hodge star is a 1-form
    stencil on the original links.
    Returns (dirs, offs, signs, lengths) shaped as in :func:`spin_tables`.
    """
    if D != 2:
        raise NotImplementedError('Taxicab paths are implemented for D=2 only.')
    from ..ops.lattice import fft_coordinates
    coord = fft_coordinates(N)
    Lmax = 2 * (N // 2)
    dirs = np.zeros((N, N, Lmax), dtype=np.int32)
    offs = np.zeros((N, N, Lmax, 2), dtype=np.int32)
    signs = np.zeros((N, N, Lmax), dtype=np.int32)
    lengths = np.zeros((N, N), dtype=np.int32)

    for i in range(N):
        dt = int(coord[i])
        for j in range(N):
            dx = int(coord[j])
            if (dt, dx) == (0, 0):
                continue
            # The stencil as slice assignments on a zero 1-form followed by a
            # one-site push per direction.
            stencil = np.zeros((2, N, N), dtype=np.int64)
            if dt > 0:
                stencil[1][:dt, 0] = +1
            elif dt < 0:
                stencil[1][dt:, 0] = -1
            stencil[1] = np.roll(stencil[1], 1, axis=0)   # push by (1, 0)
            if dx > 0:
                stencil[0][dt % N, :dx] = -1
            elif dx < 0:
                stencil[0][dt % N, dx:] = +1
            stencil[0] = np.roll(stencil[0], 1, axis=1)   # push by (0, 1)

            nz = np.nonzero(stencil)
            length = len(nz[0])
            lengths[i, j] = length
            dirs[i, j, :length] = nz[0]
            offs[i, j, :length, 0] = nz[1]
            offs[i, j, :length, 1] = nz[2]
            signs[i, j, :length] = stencil[nz]
    return dirs, offs, signs, lengths


def taxicab_mean(links, tables, weight):
    """For every displacement, the mean over starting sites of
    ``weight(P, length)``, where P = Σ sign·links along the displacement's path
    from that start and length is the path's length.

    ``links`` is a batch of D=2 1-forms (B, 2, N, N) on any device; ``tables``
    is :func:`spin_tables` or :func:`vortex_tables`; the result is (B, N, N).
    One batched gather per displacement row and chunk of configurations, each
    of at most ``GATHER_BUDGET`` elements, so memory stays bounded; the work
    is O(N⁵) per configuration."""
    dirs, offs, signs, lengths = tables
    B, _, N, _ = links.shape
    device = links.device
    flat = links.reshape(B, -1)
    t = torch.arange(N, device=device)
    starts = torch.stack(torch.meshgrid(t, t, indexing='ij'), dim=-1).reshape(-1, 2)
    per_config = N * N * N * max(dirs.shape[-1], 1)
    chunk = max(1, GATHER_BUDGET // per_config)
    out = torch.empty((B, N, N), dtype=links.dtype, device=device)
    for i in range(N):
        d = torch.as_tensor(dirs[i], device=device)
        o = torch.as_tensor(offs[i], device=device)
        sign = torch.as_tensor(signs[i], device=device).to(links.dtype)
        length = torch.as_tensor(lengths[i], device=device).to(links.dtype)[:, None]
        pos = torch.remainder(starts[None, :, None, :] + o[:, None, :, :], N)
        index = (d[:, None, :] * N + pos[..., 0]) * N + pos[..., 1]     # (N, sites, Lmax)
        for b in range(0, B, chunk):
            P = (sign[:, None, :] * flat[b:b + chunk][:, index]).sum(dim=-1)
            out[b:b + chunk, i] = weight(P, length).mean(dim=-1)
    return out
