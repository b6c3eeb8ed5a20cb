"""Where the port's entry points run, and in which dtypes.

Entry points and state constructors take ``device='cuda'`` by default: the port
runs on the card unless the caller asks for the CPU.  Without a card such a call
raises; it never falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The ``torch.device`` of an entry point's ``device`` argument.  A CUDA
    device on a machine without one raises, naming the CPU way out."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device={str(device)!r} asks for a CUDA device and none is available; '
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def field_dtypes(device):
    """(float, int) field dtypes for a device: f32/i32 on a GPU, where the kernels
    run, and f64/i64 on the CPU, where the port is held against the JAX package."""
    if torch.device(device).type == 'cuda':
        return torch.float32, torch.int32
    return torch.float64, torch.int64


def float_dtype_of(field):
    """The float dtype that goes with a field tensor: its own when it is a float,
    f64 beside int64 (the CPU path) and f32 beside int32 (the kernels' path)."""
    if field.is_floating_point():
        return field.dtype
    return torch.float64 if field.dtype == torch.int64 else torch.float32
