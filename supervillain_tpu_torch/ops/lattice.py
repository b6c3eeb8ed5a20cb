"""D-dimensional periodic hypercubic lattice and compact p-form storage.

PyTorch counterpart of :mod:`supervillain_tpu.ops.lattice`.  A p-form on a
``Lattice(D, N)`` is a tensor of shape ``(..., C(D,p), N, ..., N)``: any leading
batch axes, then the C(D,p) components listed lexicographically by their sorted
direction tuples, then the D spatial axes.

The lattice is static metadata compared by ``(D, N)``.  Incidence tables and
checkerboard masks are host NumPy constants; :meth:`Lattice.mask` hands a
checkerboard color to a device as a cached ``torch.bool`` tensor.
"""

from __future__ import annotations

from functools import cached_property
from itertools import combinations
from math import comb

import numpy as np
import torch


def fft_coordinates(n: int) -> np.ndarray:
    """FFT-convention coordinates for a periodic direction of size ``n``:
    ``0, 1, ..., n//2, -(n//2)+1, ..., -1``."""
    return np.array(list(range(0, n // 2 + 1)) + list(range(-n // 2 + 1, 0)), dtype=int)


class Lattice:
    """A D-dimensional hypercubic periodic lattice with N sites per direction."""

    def __init__(self, D: int, N: int):
        if D < 1 or N < 1:
            raise ValueError(f'Need D >= 1 and N >= 1, got D={D}, N={N}')
        self.D = int(D)
        self.N = int(N)
        self.components = {p: list(combinations(range(D), p)) for p in range(D + 1)}
        self.comp_index = {
            p: {c: i for i, c in enumerate(self.components[p])} for p in range(D + 1)
        }
        self._masks = {}

    def __eq__(self, other):
        return isinstance(other, Lattice) and (self.D, self.N) == (other.D, other.N)

    def __hash__(self):
        return hash((type(self).__name__, self.D, self.N))

    def __repr__(self):
        return f'Lattice(D={self.D}, N={self.N})'

    # -- sizes ------------------------------------------------------------

    @cached_property
    def dims(self):
        return (self.N,) * self.D

    @cached_property
    def sites(self):
        return self.N ** self.D

    @cached_property
    def origin(self):
        return (0,) * self.D

    @cached_property
    def links(self):
        return self.D * self.sites

    def form_shape(self, p: int):
        """Shape ``(C(D,p), N, ..., N)`` of a p-form."""
        return (comb(self.D, p),) + self.dims

    # -- coordinates ------------------------------------------------------

    @cached_property
    def coord_1d(self) -> np.ndarray:
        return fft_coordinates(self.N)

    @cached_property
    def coords(self) -> np.ndarray:
        """FFT-convention coordinate of each site, shape (D, N, ..., N)."""
        return np.stack(
            np.meshgrid(*(self.coord_1d for _ in range(self.D)), indexing='ij'), axis=0)

    # -- incidence tables -------------------------------------------------

    @cached_property
    def _operator_tables(self):
        """Static incidence tables ``(out_idx, in_idx, axis, sign)``: d and
        coface_sum map p -> p+1, delta and face_sum map p -> p-1."""
        D = self.D
        tables = {}
        for p in range(D):
            d_rows, co_rows = [], []
            for out_comp in self.components[p + 1]:
                out_idx = self.comp_index[p + 1][out_comp]
                for j, k_j in enumerate(out_comp):
                    in_idx = self.comp_index[p][tuple(k for k in out_comp if k != k_j)]
                    d_rows.append((out_idx, in_idx, k_j, (-1) ** j))
                    co_rows.append((out_idx, in_idx, k_j, 1))
            tables[('d', p)] = tuple(d_rows)
            tables[('coface_sum', p)] = tuple(co_rows)
        all_dirs = set(range(D))
        for p in range(1, D + 1):
            de_rows, fa_rows = [], []
            for out_comp in self.components[p - 1]:
                out_idx = self.comp_index[p - 1][out_comp]
                M = set(out_comp)
                for e in sorted(all_dirs - M):
                    in_idx = self.comp_index[p][tuple(sorted(M | {e}))]
                    j = sum(1 for m in out_comp if m < e)
                    de_rows.append((out_idx, in_idx, e, (-1) ** j))
                    fa_rows.append((out_idx, in_idx, e, 1))
            tables[('delta', p)] = tuple(de_rows)
            tables[('face_sum', p)] = tuple(fa_rows)
        return tables

    def operator_table(self, op: str, degree: int):
        try:
            return self._operator_tables[(op, degree)]
        except KeyError:
            raise ValueError(f'no operator table for op={op!r} at degree={degree}')

    # -- checkerboarding --------------------------------------------------

    @cached_property
    def checkerboard_masks(self) -> np.ndarray:
        """Boolean masks, shape (n_colors, N, ..., N), partitioning the sites so
        that no two same-color sites are nearest neighbors through the periodic
        boundary.  Even N: 2 colors by coordinate parity.  Odd N: 2^max(D,2)
        colors by (hyperoctant pair, parity)."""
        D, N = self.D, self.N
        coords = self.coords
        parity = np.mod(coords.sum(axis=0), 2)

        if N % 2 == 0:
            return np.stack([parity == c for c in (0, 1)])

        masks = []
        for b in range(1 << max(D - 1, 1)):
            if D == 1:
                pair = coords[0] >= 0 if b == 0 else coords[0] < 0
            else:
                pos = coords[0] >= 0
                neg = coords[0] < 0
                for k in range(1, D):
                    if (b >> (k - 1)) & 1 == 0:
                        pos &= coords[k] >= 0
                        neg &= coords[k] < 0
                    else:
                        pos &= coords[k] < 0
                        neg &= coords[k] >= 0
                pair = pos | neg
            for c in (0, 1):
                masks.append(pair & (parity == c))
        return np.stack(masks)

    @cached_property
    def n_colors(self):
        return len(self.checkerboard_masks)

    def mask(self, color: int, device) -> torch.Tensor:
        """Checkerboard color ``color`` as a bool tensor on ``device`` (cached)."""
        key = (color, str(torch.device(device)))
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(self.checkerboard_masks[color], device=device)
        return self._masks[key]


class Lattice2D(Lattice):
    """The D=2 lattice of the Villain main path."""

    def __init__(self, N):
        super().__init__(2, N)

    @cached_property
    def plaquettes(self):
        return self.sites

    def __repr__(self):
        return f'Lattice2D(N={self.N})'
