"""The four incidence operators on a device against the same operators on the
CPU: microseconds per call (counterpart of
:mod:`supervillain_tpu.benchmark.form_kernels`).

The JAX harness holds its operators against the sparse-matrix oracle of the
JAX package's tests; the port keeps no copy of that oracle and prints, beside
each operator's time on ``device`` (the card by default), the same operator's
time on the CPU in float64, the dtype the CPU tests use.

Run: ``python -m supervillain_tpu_torch.benchmark.form_kernels``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import Lattice, calculus

OPERATORS = ('d', 'delta', 'face_sum', 'coface_sum')


def _time(fn, x, reps, device):
    """Seconds per call of ``fn(x)`` after one warm-up call, the timed region
    ending in a synchronise on a card."""
    def synchronise():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    fn(x)
    synchronise()
    start = time.perf_counter()
    for _ in range(reps):
        fn(x)
    synchronise()
    return (time.perf_counter() - start) / reps


def benchmark_form_kernels(Ds=(2, 3, 4), Ns=(5, 9, 13), p=1, reps=10, device='cuda'):
    """Print and return rows (D, N, operator, device μs, CPU μs, CPU/device)
    for the four incidence operators on a random p-form."""
    device = resolve_device(device)
    rows = []
    print(f'{"D":>3} {"N":>5} {"op":>12} {"device μs":>12} {"cpu μs":>12} {"ratio":>9}')
    for D in Ds:
        for N in Ns:
            L = Lattice(D, N)
            host = torch.as_tensor(np.random.default_rng(0).normal(size=L.form_shape(p)))
            on_device = host.to(device=device, dtype=torch.float32 if device.type == 'cuda'
                                else torch.float64)
            for name in OPERATORS:
                op = getattr(calculus, name)
                t_device = _time(lambda x: op(L, p, x), on_device, reps, device)
                t_cpu = _time(lambda x: op(L, p, x), host, reps, torch.device('cpu'))
                rows.append((D, N, name, t_device * 1e6, t_cpu * 1e6, t_cpu / t_device))
                print(f'{D:>3} {N:>5} {name:>12} {t_device * 1e6:>12.1f} {t_cpu * 1e6:>12.1f} '
                      f'{t_cpu / t_device:>8.1f}x')
    return rows


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default='cuda')
    benchmark_form_kernels(device=ap.parse_args().device)
