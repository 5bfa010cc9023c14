"""Batched Cholesky factorization and Cholesky solve: CUDA kernels and plain versions.

Port of the two Pallas kernels of ``dgsqp_tpu/ops/linalg_pallas.py`` (``chol_batch``
and ``cho_solve_batch``) and of their dispatch wrappers ``cholesky``/``cho_solve``.

Dispatch follows the tensor's device, never a process-wide backend: a CPU tensor takes
the plain version (:func:`cholesky_plain`, :func:`cho_solve_plain`, which repeat the
kernels' arithmetic in batched tensor ops); a CUDA tensor launches the hand-written
kernel in ``csrc/`` or raises.  There is no fallback.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into shared
libraries with a plain C interface under ``build/kernels/`` (listed in ``.gitignore``),
one ``nvcc`` per source, started together, and bound with ``ctypes``.  Each wrapper
counts its kernel launches in a plain integer attribute, ``cholesky.launches`` and
``cho_solve.launches``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
SOURCES = {'chol': _CSRC / 'chol.cu', 'cho_solve': _CSRC / 'cho_solve.cu'}
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']
# largest dynamic shared memory a block may opt into on Hopper (227 KB)
SMEM_OPTIN_BYTES = 232448
_RHS_TILE = 32          # right-hand sides per block in cho_solve.cu (kTile)

_libs = {}


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels are built with the CUDA '
                           'toolkit on the machine with the card')
    return path


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f'lib{name}_{digest}.so'


def build_kernels() -> dict:
    """Compile every kernel whose library is missing (one ``nvcc`` per source, run in
    parallel) and return ``{name: ptxas report}`` for the sources compiled now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {name: _lib_path(name) for name in SOURCES if not _lib_path(name).exists()}
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    reports = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {SOURCES[name].name}:\n{log}')
        os.replace(tmp, out)
        reports[name] = log
    return reports


def _load(name: str):
    if name not in _libs:
        path = _lib_path(name)
        if not path.exists():
            build_kernels()
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        if name == 'chol':
            argtypes = [vp, vp, ci, ci, ci, vp]
            fns = (lib.dgsqp_chol_f32, lib.dgsqp_chol_f64)
        else:
            argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
            fns = (lib.dgsqp_cho_solve_f32, lib.dgsqp_cho_solve_f64)
        for fn in fns:
            fn.argtypes = argtypes
            fn.restype = ci
        _libs[name] = lib
    return _libs[name]


def _check_cuda(name, *tensors):
    t0 = tensors[0]
    if t0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{name}: float32 or float64 only, got {t0.dtype}')
    for t in tensors:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f'{name}: all operands must share device and dtype')
        if not t.is_contiguous():
            raise ValueError(f'{name}: operands must be contiguous')


def _smem_limit(device) -> int:
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, 'shared_memory_per_block_optin', SMEM_OPTIN_BYTES))


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f'{name} kernel launch failed with cudaError {rc}')


# ------------------------------------------------------------------------ plain versions
def cholesky_plain(A):
    """Column-by-column right-looking Cholesky, the kernel's arithmetic in batched
    tensor ops.  A (B, n, n) SPD -> lower L, upper triangle zero."""
    a = A.clone()
    n = a.shape[-1]
    for j in range(n):
        d = torch.sqrt(a[:, j, j])
        a[:, j + 1:, j] = a[:, j + 1:, j] / d[:, None]
        a[:, j, j] = d
        col = a[:, j + 1:, j]
        a[:, j + 1:, j + 1:] = a[:, j + 1:, j + 1:] - col[:, :, None] * col[:, None, :]
    return torch.tril(a)


def cho_solve_plain(L, b):
    """Forward then backward column substitution, the kernel's arithmetic in batched
    tensor ops.  L (B, n, n) lower, b (B, n) or (B, n, k)."""
    squeeze = b.dim() == 2
    y = (b[..., None] if squeeze else b).clone()
    n = L.shape[-1]
    for j in range(n):
        y[:, j] = y[:, j] / L[:, j, j, None]
        y[:, j + 1:] = y[:, j + 1:] - L[:, j + 1:, j, None] * y[:, j, None, :]
    for j in range(n - 1, -1, -1):
        y[:, j] = y[:, j] / L[:, j, j, None]
        y[:, :j] = y[:, :j] - L[:, j, :j, None] * y[:, j, None, :]
    return y[..., 0] if squeeze else y


# ----------------------------------------------------------------------------- wrappers
def chol_smem_bytes(n: int, itemsize: int) -> int:
    return n * (n | 1) * itemsize


def cho_solve_smem_bytes(n: int, itemsize: int) -> int:
    return (n * (n | 1) + n * _RHS_TILE) * itemsize


def cholesky(A):
    """Lower Cholesky factor of each matrix of A (B, n, n); upper triangle zero.

    A CPU tensor takes :func:`cholesky_plain`; a CUDA tensor launches ``chol.cu``."""
    if A.device.type == 'cpu':
        return cholesky_plain(A)
    if A.device.type != 'cuda':
        raise ValueError(f'cholesky: unsupported device {A.device}')
    if A.dim() != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f'cholesky: expected (B, n, n), got {tuple(A.shape)}')
    _check_cuda('cholesky', A)
    B, n = A.shape[0], A.shape[-1]
    if chol_smem_bytes(n, A.element_size()) > _smem_limit(A.device):
        raise ValueError(f'cholesky: n={n} in {A.dtype} does not fit in shared memory')
    L = torch.empty_like(A)
    if B == 0 or n == 0:
        return L
    lib = _load('chol')
    fn = lib.dgsqp_chol_f32 if A.dtype == torch.float32 else lib.dgsqp_chol_f64
    rc = fn(A.data_ptr(), L.data_ptr(), B, n, A.device.index or 0,
            torch.cuda.current_stream(A.device).cuda_stream)
    _raise_on(rc, 'cholesky')
    cholesky.launches += 1
    return L


cholesky.launches = 0


def cho_solve(L, b):
    """Solve (L L') x = b for each batch element; L (B, n, n) lower, b (B, n) or
    (B, n, k).  A CPU tensor takes :func:`cho_solve_plain`; a CUDA tensor launches
    ``cho_solve.cu``."""
    if L.device.type == 'cpu':
        return cho_solve_plain(L, b)
    if L.device.type != 'cuda':
        raise ValueError(f'cho_solve: unsupported device {L.device}')
    if L.dim() != 3 or L.shape[-1] != L.shape[-2] or b.dim() not in (2, 3) \
            or b.shape[:2] != L.shape[:2]:
        raise ValueError(f'cho_solve: expected L (B, n, n) and b (B, n[, k]), got '
                         f'{tuple(L.shape)} and {tuple(b.shape)}')
    _check_cuda('cho_solve', L, b)
    B, n = L.shape[0], L.shape[-1]
    k = 1 if b.dim() == 2 else b.shape[-1]
    if cho_solve_smem_bytes(n, L.element_size()) > _smem_limit(L.device):
        raise ValueError(f'cho_solve: n={n} in {L.dtype} does not fit in shared memory')
    x = torch.empty_like(b)
    if B == 0 or n == 0 or k == 0:
        return x
    lib = _load('cho_solve')
    fn = lib.dgsqp_cho_solve_f32 if L.dtype == torch.float32 else lib.dgsqp_cho_solve_f64
    rc = fn(L.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, k, L.device.index or 0,
            torch.cuda.current_stream(L.device).cuda_stream)
    _raise_on(rc, 'cho_solve')
    cho_solve.launches += 1
    return x


cho_solve.launches = 0
