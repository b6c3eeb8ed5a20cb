"""State carried between the JAX package and the port.

The system has no trained weights: what carries over is the field state and
the action's parameters.  A configuration is a dict of NumPy arrays in the JAX
package's layout, ``{'phi': (..., 1, N, N), 'n': (..., 2, N, N)}``, with any
leading batch axes.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import Villain
from .models.villain import field_dtypes
from .ops import Lattice2D


def state_from_numpy(cfg, device='cpu', dtypes=None):
    """The port's tensors for a NumPy configuration, on ``device``, in
    ``dtypes = (float, int)`` or the device's :func:`field_dtypes`."""
    fdt, idt = dtypes or field_dtypes(device)
    return {'phi': torch.as_tensor(np.asarray(cfg['phi']), device=device).to(fdt),
            'n': torch.as_tensor(np.asarray(cfg['n']), device=device).to(idt)}


def state_to_numpy(state):
    """NumPy arrays for the port's tensors (moved to the host)."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def villain_action(N, kappa, W):
    """The Villain action on the D=2 lattice of side N."""
    return Villain(Lattice2D(N), kappa, W)
