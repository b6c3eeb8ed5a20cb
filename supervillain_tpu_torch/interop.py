"""State carried between the JAX package and the port.

The system has no trained weights: what carries over is the field state and
the action's parameters.  A configuration is a dict of NumPy arrays in the JAX
package's layout, ``{'phi': (..., 1, N, N), 'n': (..., 2, N, N)}`` (Villain)
or ``{'m': (..., 2, N, N), 'v': (..., 1, N, N)}`` (Worldline), with any
leading batch axes.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import field_dtypes, resolve_device
from .models import Villain, Worldline
from .ops import Lattice2D


def state_from_numpy(cfg, device='cuda', dtypes=None):
    """The port's Villain tensors for a NumPy configuration, on ``device``, in
    ``dtypes = (float, int)`` or the device's :func:`field_dtypes`."""
    device = resolve_device(device)
    fdt, idt = dtypes or field_dtypes(device)
    return {'phi': torch.as_tensor(np.asarray(cfg['phi']), device=device).to(fdt),
            'n': torch.as_tensor(np.asarray(cfg['n']), device=device).to(idt)}


def worldline_state_from_numpy(cfg, W, device='cuda', dtypes=None):
    """The port's Worldline tensors for a NumPy configuration, on ``device``:
    int m, and v int at finite W or float at W=∞, in ``dtypes = (float, int)``
    or the device's :func:`field_dtypes` (f64/i64 on the CPU, f32/i32 on the card)."""
    device = resolve_device(device)
    fdt, idt = dtypes or field_dtypes(device)
    return {'m': torch.as_tensor(np.asarray(cfg['m']), device=device).to(idt),
            'v': torch.as_tensor(np.asarray(cfg['v']), device=device).to(
                fdt if W == float('inf') else idt)}


def state_to_numpy(state):
    """NumPy arrays for the port's tensors (moved to the host)."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def villain_action(N, kappa, W):
    """The Villain action on the D=2 lattice of side N."""
    return Villain(Lattice2D(N), kappa, W)


def worldline_action(N, kappa, W):
    """The Worldline action on the D=2 lattice of side N."""
    return Worldline(Lattice2D(N), kappa, W)
