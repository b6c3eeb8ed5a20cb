"""Host-tier ``Form``: a NumPy array that carries its degree and lattice.

Counterpart of :mod:`supervillain_tpu.ops.form`.  The port computes on plain
tensors whose degree the caller states; ``Form`` is the host half, for
interactive work, post-processing and plotting:

* elementwise ufuncs whose Form operands share one degree return a Form of that
  degree; mixed-degree arithmetic and reductions return plain arrays;
* ``component(*dirs)`` is a writable spatial view;
* ``to_interlaced``/``from_interlaced`` embed into and extract from the (2N)^D
  layout;
* ``face_sum``/``coface_sum`` return the (p∓1)-form unsigned incidence sums
  (computed by :mod:`.calculus` on the CPU), or 0 at the degree boundary.

A Form goes to a device as ``torch.as_tensor(np.asarray(form), device=...)``,
and a tensor comes back as ``lattice.form(p, tensor)``.
"""

from __future__ import annotations

from math import comb

import numpy as np
import torch

from .lattice import Lattice
from . import calculus, interlaced

__all__ = ['Form']


def host_operator(op, lattice, p, f):
    """``op(lattice, p, f)`` of :mod:`.calculus` on a NumPy array, run on the
    CPU, returned as NumPy."""
    return op(lattice, p, torch.as_tensor(np.asarray(f))).numpy()


class Form(np.ndarray):
    """A p-form on a :class:`Lattice`: shape ``(..., C(D,p), N, ..., N)`` with the
    component axis indexing components lexicographically by sorted directions."""

    __batch_tag__ = 'Form'

    def __new__(cls, input_array, *, degree, lattice, dtype=None):
        obj = np.asarray(input_array, dtype=dtype).view(cls)
        if obj.shape[-lattice.D - 1:] != lattice.form_shape(degree):
            raise ValueError(
                f'data of shape {obj.shape} is not a (batch of) degree-{degree} '
                f'form(s) on {lattice!r}: expected trailing {lattice.form_shape(degree)}')
        obj.degree = degree
        obj.lattice = lattice
        return obj

    @classmethod
    def spatial_shape(cls, *, degree, lattice):
        """``(C(D,p), N, ..., N)``."""
        return (comb(lattice.D, degree),) + (lattice.N,) * lattice.D

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.degree = getattr(obj, 'degree', None)
        self.lattice = getattr(obj, 'lattice', None)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        forms = [x for x in inputs if isinstance(x, Form)]
        degrees = {f.degree for f in forms}
        raw = tuple(np.asarray(x) for x in inputs)
        out = kwargs.get('out')
        if out is not None:
            kwargs['out'] = tuple(np.asarray(o) for o in out)
        result = getattr(ufunc, method)(*raw, **kwargs)
        # Re-wrap only a result that is still a whole form of the one degree:
        # a sliced view keeps the metadata but is no longer a form.
        if (len(degrees) == 1 and isinstance(result, np.ndarray)
                and forms and result.shape == forms[0].shape
                and forms[0].lattice is not None):
            lattice, degree = forms[0].lattice, forms[0].degree
            if result.shape[-lattice.D - 1:] == lattice.form_shape(degree):
                return Form(result, degree=degree, lattice=lattice)
        return result

    def component(self, *dirs):
        """Writable spatial view of one component, shape ``(N, ..., N)``:
        ``f.component(0, 2)`` or ``f.component((0, 2))``."""
        if len(dirs) == 1 and hasattr(dirs[0], '__iter__'):
            dirs = tuple(dirs[0])
        idx = self.lattice.comp_index[self.degree][tuple(sorted(dirs))]
        return np.asarray(self)[idx]

    def to_interlaced(self):
        """Embed into the (2N)^D interlaced array (odd coordinates = form directions)."""
        return interlaced.to_interlaced(self.lattice, self.degree, np.asarray(self))

    @classmethod
    def from_interlaced(cls, p, data, lattice=None):
        """Inverse of :meth:`to_interlaced`; ``lattice`` inferred from the shape."""
        data = np.asarray(data)
        if lattice is None:
            lattice = Lattice(data.ndim, data.shape[0] // 2)
        return cls(interlaced.from_interlaced(lattice, p, data), degree=p, lattice=lattice)

    def face_sum(self):
        """(p-1)-form unsigned sum over faces; ``0`` for a 0-form."""
        if self.degree == 0:
            return 0
        out = host_operator(calculus.face_sum, self.lattice, self.degree, self)
        return Form(out, degree=self.degree - 1, lattice=self.lattice)

    def coface_sum(self):
        """(p+1)-form unsigned sum onto cofaces; ``0`` for a top form."""
        if self.degree == self.lattice.D:
            return 0
        out = host_operator(calculus.coface_sum, self.lattice, self.degree, self)
        return Form(out, degree=self.degree + 1, lattice=self.lattice)

    def __repr__(self):
        return f'Form(degree={self.degree}, shape={self.shape}, lattice={self.lattice!r})'
