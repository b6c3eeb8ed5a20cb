"""The sparse-operator calling convention as masked dense torch operations.

Counterpart of :mod:`supervillain_tpu.ops.sparse`.  The input-sparse
``delta_sparse``/``d_sparse`` and output-sparse ``coface_sum_at``/``face_sum_at``
exist for code written against that convention: each is the dense operator of
:mod:`.calculus` applied to the equivalent sparse form (or read out at the
requested cells), on the device of the values (or form) it is given.
"""

from __future__ import annotations

import numpy as np
import torch

from .lattice import Lattice
from . import calculus as calc


def _embed(lattice: Lattice, degree: int, component: int, color, values):
    """Dense form with ``values`` on ``component`` at the sites ``color``."""
    values = _tensor(values)
    form = torch.zeros(lattice.form_shape(degree), dtype=values.dtype, device=values.device)
    form[(component,) + tuple(torch.as_tensor(c, device=values.device) for c in color)] = values
    return form


def _accumulate(result, out):
    if out is None:
        return result
    if isinstance(out, torch.Tensor):
        out += result.to(out.dtype)
    else:
        out += result.cpu().numpy().astype(out.dtype, copy=False)
    return out


def delta_sparse(lattice, degree, component, color, values, out=None):
    """δ of a degree-form supported on one (component, color).  With ``out``
    (an array or a tensor) the result is added into it."""
    return _accumulate(calc.delta(lattice, degree, _embed(lattice, degree, component, color,
                                                          values)), out)


def d_sparse(lattice, degree, component, color, values, out=None):
    """d of a degree-form supported on one (component, color)."""
    return _accumulate(calc.d(lattice, degree, _embed(lattice, degree, component, color,
                                                      values)), out)


def _tensor(f):
    return f if isinstance(f, torch.Tensor) else torch.as_tensor(np.asarray(f))


def _at(dense, component, color):
    return dense[(component,) + tuple(torch.as_tensor(c, device=dense.device) for c in color)]


def coface_sum_at(lattice, degree, f, component, color):
    """The coface sum of a degree-form ``f``, read out at one (component, color)
    of the (degree+1)-form output."""
    return _at(calc.coface_sum(lattice, degree, _tensor(f)), component, color)


def face_sum_at(lattice, degree, f, component, color):
    """The face sum of a degree-form ``f``, read out at one (component, color)
    of the (degree-1)-form output."""
    return _at(calc.face_sum(lattice, degree, _tensor(f)), component, color)
