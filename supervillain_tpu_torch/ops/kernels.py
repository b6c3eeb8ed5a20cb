"""Build and load the hand-written CUDA kernels of ``supervillain_tpu_torch/csrc``.

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface and loaded with ``ctypes``.  The build happens at
first use, into ``build/torch_kernels/<hash of the sources>/`` beside the
package (``SUPERVILLAIN_TORCH_BUILD`` overrides the directory), so a second
process with unchanged sources loads the library without compiling.  Nothing
is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / 'csrc'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P, _I, _LL, _ULL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_ulonglong, ctypes.c_float)
_WORLDLINE_SWEEPS = [_P] * 11 + [_I, _I, _I, _F, _F, _F, _I, _I, _ULL, _P]
_WORLDLINE_WORMS = [_P] * 7 + [_LL, _I, _I, _F, _F, _I, _LL, _ULL, _P]
_SIGNATURES = {
    'sv_sweeps': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _F, _I, _F, _ULL, _P],
    'sv_worms': [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _F, _I, _I, _LL, _I, _ULL, _P],
    'sv_worldline_sweeps': _WORLDLINE_SWEEPS,
    'sv_worldline_sweeps_winf': _WORLDLINE_SWEEPS,
    'sv_worldline_worms': _WORLDLINE_WORMS,
    'sv_worldline_worms_winf': _WORLDLINE_WORMS,
}

_library = None
#: nvcc's output (registers, spills) of the build this process made, if any.
build_log = ''


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in ('.cu', '.cuh'))


def build_dir() -> pathlib.Path:
    default = CSRC.parents[1] / 'build' / 'torch_kernels'
    return pathlib.Path(os.environ.get('SUPERVILLAIN_TORCH_BUILD', default))


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = pathlib.Path(cuda_home) / 'bin' / 'nvcc'
    if candidate.exists():
        return str(candidate)
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA toolkit to build')


def library_path() -> pathlib.Path:
    digest = hashlib.sha256()
    for p in _sources():
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return build_dir() / digest.hexdigest()[:16] / 'libsupervillain_kernels.so'


def build() -> pathlib.Path:
    """Compile the kernels unless a library built from the same sources exists."""
    global build_log
    target = library_path()
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources() if p.suffix == '.cu']
    with tempfile.NamedTemporaryFile(dir=target.parent, suffix='.so', delete=False) as tmp:
        partial = tmp.name
    try:
        done = subprocess.run([_nvcc(), *NVCC_FLAGS, '-I', str(CSRC), '-o', partial, *cu],
                              capture_output=True, text=True)
        build_log = done.stdout + done.stderr
        if done.returncode != 0:
            raise RuntimeError(f'nvcc failed ({done.returncode}):\n{build_log}')
        os.replace(partial, target)
    finally:
        if os.path.exists(partial):
            os.unlink(partial)
    return target


def library():
    """The loaded kernel library, built on first use."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.sv_error_string.argtypes = [ctypes.c_int]
        lib.sv_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def check(code: int, what: str):
    """Raise when a C entry point returned a CUDA error."""
    if code != 0:
        message = library().sv_error_string(code).decode()
        raise RuntimeError(f'{what}: CUDA error {code} ({message})')


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def seed_from(generator: torch.Generator) -> int:
    """A 63-bit kernel seed drawn from ``generator`` (on any device)."""
    return int(torch.randint(0, 2 ** 63 - 1, (), generator=generator, device=generator.device))


def _require_batch(first, second, dtypes, components):
    """Validate a chain batch of two fields ``(name, tensor)`` for the kernels:
    (B, c, N, N) of the given dtypes and component counts, contiguous, on one
    CUDA device, N even.  Returns (B, N)."""
    (na, a), (nb, b) = first, second
    if a.device.type != 'cuda' or b.device != a.device:
        raise ValueError(f'kernels need {na} and {nb} on one CUDA device, got {a.device} and {b.device}')
    if (a.dtype, b.dtype) != dtypes:
        da, db = (str(d).removeprefix('torch.') for d in dtypes)
        raise TypeError(f'kernels need {da} {na} and {db} {nb}, got {a.dtype} and {b.dtype}')
    ca, cb = components
    if a.dim() != 4 or a.shape[1] != ca or a.shape[2] != a.shape[3]:
        raise ValueError(f'{na} must be (B, {ca}, N, N), got {tuple(a.shape)}')
    B, _, N, _ = a.shape
    if tuple(b.shape) != (B, cb, N, N):
        raise ValueError(f'{nb} must be (B, {cb}, N, N) = {(B, cb, N, N)}, got {tuple(b.shape)}')
    if N < 2 or N % 2 != 0:
        raise ValueError(f'kernels need an even N >= 2, got N={N}')
    if 2 * B * N * N >= 2 ** 31:
        raise ValueError(f'{B} chains of N={N} exceed the kernels\' 32-bit site indexing')
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f'kernels need contiguous {na} and {nb}')
    return B, N


def require_fields(phi, n):
    """A Villain chain batch: φ (B, 1, N, N) float32 and n (B, 2, N, N) int32."""
    return _require_batch(('phi', phi), ('n', n), (torch.float32, torch.int32), (1, 2))


def require_worldline_fields(m, v, W):
    """A Worldline chain batch: m (B, 2, N, N) int32 and v (B, 1, N, N), int32
    at finite W and float32 at W = inf."""
    vdt = torch.float32 if W == float('inf') else torch.int32
    return _require_batch(('m', m), ('v', v), (torch.int32, vdt), (2, 1))
