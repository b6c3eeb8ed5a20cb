"""D-dimensional periodic hypercubic lattice and compact p-form storage.

PyTorch counterpart of :mod:`supervillain_tpu.ops.lattice`.  A p-form on a
``Lattice(D, N)`` is a tensor of shape ``(..., C(D,p), N, ..., N)``: any leading
batch axes, then the C(D,p) components listed lexicographically by their sorted
direction tuples, then the D spatial axes.

The lattice is static metadata compared by ``(D, N)``.  Incidence tables,
checkerboard masks, coordinates and point-group permutations are host NumPy
constants; :meth:`Lattice.mask` hands a checkerboard color to a device as a
cached ``torch.bool`` tensor.  The Fourier methods run ``torch.fft`` on the
device of the tensor they are given.  :meth:`Lattice.zeros` and
:meth:`Lattice.random` make device tensors, :meth:`Lattice.form` a host-tier
:class:`~.form.Form`.
"""

from __future__ import annotations

from functools import cached_property
from itertools import combinations, permutations
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

    @property
    def dim(self):
        return self.D

    @cached_property
    def links(self):
        return self.D * self.sites

    @cached_property
    def cells_of_degree(self):
        """The number of p-cells, C(D,p)·N^D, for every degree p."""
        return {p: comb(self.D, p) * self.sites for p in range(self.D + 1)}

    @cached_property
    def cells_of_codegree(self):
        return {q: self.cells_of_degree[self.D - q] for q in range(self.D + 1)}

    def form_shape(self, p: int):
        """Shape ``(C(D,p), N, ..., N)`` of a p-form."""
        return (comb(self.D, p),) + self.dims

    # -- factories --------------------------------------------------------

    def zeros(self, p: int, dtype=torch.float32, device='cpu'):
        """A zero p-form tensor on ``device``."""
        return torch.zeros(self.form_shape(p), dtype=dtype, device=device)

    def form(self, p: int, data=None, dtype=float):
        """Host-tier :class:`~.form.Form` of degree ``p``: zeros of ``dtype``
        without ``data``, else ``data`` (a tensor is copied to the host) as a Form."""
        from .form import Form
        if data is None:
            return Form(np.zeros(self.form_shape(p), dtype=dtype), degree=p, lattice=self)
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        return Form(np.asarray(data), degree=p, lattice=self)

    def random(self, p: int, generator=None, dtype=torch.float32, device='cpu'):
        """A uniform [0, 1) p-form tensor on ``device``, drawn from ``generator``
        (a ``torch.Generator`` on that device) or from torch's default one."""
        return torch.rand(self.form_shape(p), generator=generator, dtype=dtype, device=device)

    # -- coordinates ------------------------------------------------------

    @cached_property
    def coord_1d(self) -> np.ndarray:
        return fft_coordinates(self.N)

    @cached_property
    def coords(self) -> np.ndarray:
        """FFT-convention coordinate of each site, shape (D, N, ..., N)."""
        return np.stack(
            np.meshgrid(*(self.coord_1d for _ in range(self.D)), indexing='ij'), axis=0)

    @cached_property
    def coordinates(self) -> np.ndarray:
        """Every site's coordinates, shape (sites, D)."""
        return self.coords.reshape(self.D, -1).T

    @cached_property
    def R_squared(self) -> np.ndarray:
        """Distance squared from the origin at each site, shape (N, ..., N)."""
        return np.sum(self.coords ** 2, axis=0)

    def mod(self, x):
        """Map integer coordinates into the FFT-convention range [-(N//2)+1, N//2]."""
        return self.coord_1d[np.mod(np.asarray(x), self.N)]

    def distance_squared(self, a, b):
        """Shortest-path squared distance on the torus between coordinate vectors."""
        return np.sum(self.mod(np.asarray(a) - np.asarray(b)) ** 2, axis=-1)

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
    def checkerboarding(self):
        """``np.where``-style index tuples of each color's sites."""
        return tuple(np.where(m) for m in self.checkerboard_masks)

    @cached_property
    def n_colors(self):
        return len(self.checkerboard_masks)

    def mask(self, color: int, device) -> torch.Tensor:
        """Checkerboard color ``color`` as a bool tensor on ``device`` (cached)."""
        key = (color, str(torch.device(device)))
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(self.checkerboard_masks[color], device=device)
        return self._masks[key]

    # -- Fourier methods --------------------------------------------------

    def _spatial_axes(self):
        return tuple(range(-self.D, 0))

    def fft(self, form, axes=None):
        """Ortho-normalized DFT over the last D (spatial) axes."""
        return torch.fft.fftn(torch.as_tensor(form), norm='ortho',
                              dim=axes if axes is not None else self._spatial_axes())

    def ifft(self, form, axes=None):
        """Ortho-normalized inverse DFT over the last D (spatial) axes."""
        return torch.fft.ifftn(torch.as_tensor(form), norm='ortho',
                               dim=axes if axes is not None else self._spatial_axes())

    def convolution(self, f, g, axes=None):
        r"""Fourier-accelerated periodic convolution ``(f * g)(r) = Σ_x f(x) g(r - x)``."""
        return np.sqrt(self.sites) * self.ifft(self.fft(f, axes) * self.fft(g, axes), axes)

    def correlation(self, f, g, axes=None):
        r"""Fourier-accelerated cross-correlation
        ``(f ⋆ g)(r) = (1/N^D) Σ_x conj(f(x)) g(x - r)``."""
        return self.fft(self.fft(f, axes).conj() * self.fft(g, axes), axes) / np.sqrt(self.sites)

    # -- reshaping --------------------------------------------------------

    def linearize(self, v, dims=(-1,)):
        """Flatten each of the listed D-axis spatial blocks of ``v`` (a tensor or
        an array) into one sites-sized axis (inverse of :meth:`coordinatize`)."""
        v = v if isinstance(v, torch.Tensor) else np.asarray(v)
        shape = v.shape
        future_dims = len(shape) - (self.D - 1) * len(set(dims))
        dm = set(d % future_dims for d in dims)
        new_shape = []
        idx = 0
        for i in range(future_dims):
            if i not in dm:
                new_shape.append(shape[idx])
                idx += 1
            else:
                new_shape.append(self.sites)
                idx += self.D
        return v.reshape(new_shape)

    def coordinatize(self, v, dims=(-1,), center_origin=False):
        """Unflatten each listed sites-sized axis of ``v`` (a tensor or an array)
        back into D spatial axes; ``center_origin`` rolls the origin to the middle."""
        v = v if isinstance(v, torch.Tensor) else np.asarray(v)
        to_reshape = np.sort(np.remainder(np.array(dims), len(v.shape)))
        new_shape = ()
        for i, s in enumerate(v.shape):
            new_shape += ((s,) if i not in to_reshape else self.dims)
        reshaped = v.reshape(new_shape)
        if not center_origin:
            return reshaped
        axes = [int(a) + d for a in to_reshape + np.arange(len(to_reshape)) * (self.D - 1)
                for d in range(self.D)]
        if isinstance(reshaped, torch.Tensor):
            return torch.roll(reshaped, [self.N // 2] * len(axes), dims=axes)
        return np.roll(reshaped, self.N // 2, axis=axes)

    # -- hyperoctahedral symmetrization -----------------------------------

    @cached_property
    def _hyperoctahedral_permutations(self) -> np.ndarray:
        """Site-index permutations, shape (D!·2^D, sites), of the signed
        coordinate permutations (the point group B_D of the hypercubic lattice):
        row g maps site k to the site at g's image of k's coordinates."""
        place = self.N ** np.arange(self.D - 1, -1, -1)
        rows = []
        for perm in permutations(range(self.D)):
            for signs in np.ndindex(*([2] * self.D)):
                image = (1 - 2 * np.array(signs)) * self.coordinates[:, list(perm)]
                rows.append(np.mod(image, self.N) @ place)
        return np.stack(rows)

    def symmetrize(self, correlator, dims=(-1,)):
        """Average over the hyperoctahedral group: project onto the trivial irrep
        of the lattice point group, as one gather of every group element's
        permutation.  Returns the type it is given (tensor or array)."""
        as_array = not isinstance(correlator, torch.Tensor)
        C = self.linearize(torch.as_tensor(np.asarray(correlator) if as_array else correlator),
                           dims=dims)
        axis = list(dims)[0] % C.dim()
        perms = torch.as_tensor(self._hyperoctahedral_permutations, device=C.device)
        taken = C.index_select(axis, perms.reshape(-1))
        taken = taken.reshape(C.shape[:axis] + perms.shape + C.shape[axis + 1:])
        result = self.coordinatize(taken.sum(dim=axis) / len(perms), dims=dims)
        return result.cpu().numpy() if as_array else result

    # -- persistence ------------------------------------------------------

    def to_h5(self, group):
        group.attrs['type'] = 'Lattice'
        group['D'] = self.D
        group['N'] = self.N

    @classmethod
    def from_h5(cls, group):
        return cls(int(np.asarray(group['D'])), int(np.asarray(group['N'])))


class Lattice2D(Lattice):
    """The D=2 lattice of the Villain main path."""

    def __init__(self, N):
        super().__init__(2, N)

    @property
    def nt(self):
        return self.N

    @property
    def nx(self):
        return self.N

    @property
    def t(self):
        return self.coord_1d

    @property
    def x(self):
        return self.coord_1d

    @property
    def T(self):
        return self.coords[0]

    @property
    def X(self):
        return self.coords[1]

    @cached_property
    def plaquettes(self):
        return self.sites

    def __repr__(self):
        return f'Lattice2D(N={self.N})'

    @classmethod
    def from_h5(cls, group):
        return cls(int(np.asarray(group['N'])))

    def plot_form(self, p, form, axis, label=None, cmap=None, pointsize=200,
                  linkwidth=0.025, markerstyle='o'):
        """Draw a p-form (an array or a tensor) on the matplotlib ``axis``:
        0-forms as colored sites, 1-forms as colored links, 2-forms as colored
        plaquettes.  matplotlib is imported here, not with the module."""
        import matplotlib.pyplot as plt
        from matplotlib import colors as mcolors
        if isinstance(form, torch.Tensor):
            form = form.detach().cpu().numpy()
        form = np.asarray(form)
        N = self.N
        norm = mcolors.CenteredNorm()
        cmap = cmap or plt.get_cmap('PiYG')
        if p == 0:
            sc = axis.scatter(*np.meshgrid(range(N), range(N), indexing='ij'),
                              c=form[0], cmap=cmap, norm=norm, s=pointsize,
                              marker=markerstyle, label=label)
            plt.colorbar(sc, ax=axis)
        elif p == 1:
            t, x = np.meshgrid(range(N), range(N), indexing='ij')
            cnorm = mcolors.CenteredNorm()
            cnorm.autoscale(form)
            for mu, (dt, dx) in enumerate(((1, 0), (0, 1))):
                for tt in range(N):
                    for xx in range(N):
                        axis.plot([tt, tt + dt], [xx, xx + dx],
                                  color=cmap(cnorm(form[mu, tt, xx])),
                                  linewidth=1 + 100 * linkwidth)
            axis.scatter(t, x, color='black', s=pointsize / 10, zorder=3)
        elif p == 2:
            im = axis.imshow(form[0].T, origin='lower', cmap=cmap, norm=norm,
                             extent=(-0.5, N - 0.5, -0.5, N - 0.5))
            plt.colorbar(im, ax=axis)
        else:
            raise ValueError(f'plot_form supports p in (0, 1, 2), got {p}')
        axis.set_xlabel('t')
        axis.set_ylabel('x')
        if label:
            axis.set_title(label)
        return axis


def lattice_from_h5(group):
    """The lattice stored in ``group`` (by either package): a :class:`Lattice2D`
    in D=2, where the port's actions live, else a :class:`Lattice`."""
    D, N = int(np.asarray(group['D'])), int(np.asarray(group['N']))
    return Lattice2D(N) if D == 2 else Lattice(D, N)
