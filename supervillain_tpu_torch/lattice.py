"""The lattice namespace in both calling conventions.

Counterpart of :mod:`supervillain_tpu.lattice`.  The operators of
:mod:`.ops.calculus` take ``(lattice, p, f)`` with f a tensor; code written in
the reference's convention calls ``d(form)`` with the degree carried by a
host-tier :class:`Form`.  The wrappers here accept both::

    from supervillain_tpu_torch.lattice import Lattice, d
    L = Lattice(2, 5)
    f = L.form(1)          # a host Form of degree 1
    df = d(f)              # a Form of degree 2
    df2 = d(L, 1, t)       # a tensor t: the tensor convention, on t's device
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.lattice import Lattice, Lattice2D
from .ops.form import Form
from .ops import calculus as _calculus
from .ops.sparse import delta_sparse, d_sparse, coface_sum_at, face_sum_at
from .ops.calculus import push, pull

__all__ = [
    'Lattice', 'Lattice2D', 'Form', 'd', 'delta', 'delta_sparse', 'd_sparse',
    'coface_sum_at', 'face_sum_at', 'laplacian', 'star', 'wedge', 'push', 'pull',
]


def _host(f):
    return torch.as_tensor(np.asarray(f))


def _unary(name, out_degree):
    base = getattr(_calculus, name)

    def op(*args):
        if len(args) == 1:
            f = args[0]
            if not isinstance(f, Form):
                raise TypeError(f'{name}(f) requires a Form (degree metadata); '
                                f'for tensors call {name}(lattice, p, f)')
            # At the degree boundaries the reference returns scalar 0.
            if name == 'd' and f.degree == f.lattice.D:
                return 0
            if name == 'delta' and f.degree == 0:
                return 0
            out = base(f.lattice, f.degree, _host(f)).numpy()
            return Form(out, degree=out_degree(f.lattice, f.degree), lattice=f.lattice)
        return base(*args)

    op.__name__ = name
    op.__doc__ = (f'``{name}``: ``{name}(form)`` (a Form of degree p, returns a Form) or '
                  f'``{name}(lattice, p, f)`` (a tensor, returns a tensor on its device). '
                  f'See :func:`supervillain_tpu_torch.ops.calculus.{name}`.')
    return op


d = _unary('d', lambda L, p: p + 1)
delta = _unary('delta', lambda L, p: p - 1)
laplacian = _unary('laplacian', lambda L, p: p)
star = _unary('star', lambda L, p: L.D - p)


def wedge(*args):
    """``wedge(a, b)`` of Forms (a Form of degree pa + pb), or the tensor
    convention ``wedge(lattice, pa, a, pb, b)``."""
    if len(args) == 2:
        a, b = args
        if not (isinstance(a, Form) and isinstance(b, Form)):
            raise TypeError('wedge(a, b) requires Forms; '
                            'for tensors call wedge(lattice, pa, a, pb, b)')
        if a.lattice != b.lattice:
            raise ValueError(f'wedge requires Forms on the same lattice; '
                             f'got {a.lattice} and {b.lattice}')
        out = _calculus.wedge(a.lattice, a.degree, _host(a), b.degree, _host(b)).numpy()
        return Form(out, degree=a.degree + b.degree, lattice=a.lattice)
    return _calculus.wedge(*args)
