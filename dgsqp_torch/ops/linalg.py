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
``cho_solve.launches``, the same launches by matrix size n in a dict,
``cholesky.launches_by_n`` and ``cho_solve.launches_by_n``, and the times it raised a
kernel's shared-memory limit, ``cholesky.attr_sets`` and ``cho_solve.attr_sets``: once
per kernel, dtype, device and largest size seen, not once per launch.  Every wrapper of a
kernel of ``csrc/`` (these two, ``ops/dynamics.py`` ``dyn_step``) names its launch
counters with :func:`register_launches`; :func:`launch_counts` reads them all and
:func:`add_launches` adds to them, for code that replays launches it did not make (the
CUDA graphs of ``utils/cuda_graphs.py``).

``chol.cu`` factors by panels of ``CHOL_PANEL`` columns.  ``cho_solve.cu`` holds two
kernels and :func:`cho_solve_plan` picks one from (n, k, dtype) alone: up to
``WARP_PATH_MAX_K`` = 16 right-hand sides take the warp path (one warp per
right-hand-side column, substitution by warp shuffles; k = 1 is the interior-point
iteration's solve), more take the column path (one thread per column in tiles of
``COLUMN_TILE`` = 64 columns, or 32 where k or shared memory leave no room for 64;
k = 64 is the polish's solve).  The ``cho_solve`` constants were chosen by timing on an
H100 with ``scripts/torch_tune_kernels.py``.
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
SOURCES = {'chol': _CSRC / 'chol.cu', 'cho_solve': _CSRC / 'cho_solve.cu',
           'dyn_step': _CSRC / 'dyn_step.cu'}
_HEADERS = [_CSRC / 'common.cuh']
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']
# largest dynamic shared memory a block may opt into on Hopper (227 KB)
SMEM_OPTIN_BYTES = 232448
CHOL_PANEL = 8          # columns per panel in chol.cu (its kNb; the launch checks it)
CHOL_MAX_N = 256        # chol.cu gives each row of a panel's column block one thread
WARP_PATH_MAX_K = 16    # cho_solve.cu: most right-hand sides that take the warp path
WARP_PATH_WARPS = 8     # most warps (columns) of one matrix in a warp-path block
WARP_PATH_LOADERS = 8    # fewest warps of a warp-path block: all of them copy L
COLUMN_TILE = 64        # columns (threads) per block on the column path, 32 if it must

_libs = {}
_launch_counters = []   # (wrapper, names of its launch counters)
_smem_limits = {}       # device index -> opt-in shared memory per block
_attr_smem = {}         # (kernel, variant, dtype, device index) -> largest limit set


def register_launches(wrapper, *names):
    """Name ``wrapper``'s launch counters: its attributes ``names``, each an integer or
    a dict of integers by shape."""
    _launch_counters.append((wrapper, names))


def launch_counts() -> dict:
    """Every registered launch counter, flat: {(wrapper, counter, key): n}, ``key``
    None for an integer and the entry's key in a dict."""
    out = {}
    for wrapper, names in _launch_counters:
        for name in names:
            v = getattr(wrapper, name)
            if isinstance(v, dict):
                out.update(((wrapper, name, key), n) for key, n in v.items())
            else:
                out[(wrapper, name, None)] = v
    return out


def add_launches(counts: dict, sign: int = 1):
    """Add ``sign`` times ``counts`` (in :func:`launch_counts`' form) to the counters."""
    for (wrapper, name, key), n in counts.items():
        if key is None:
            setattr(wrapper, name, getattr(wrapper, name) + sign * n)
        else:
            d = getattr(wrapper, name)
            d[key] = d.get(key, 0) + sign * n


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels are built with the CUDA '
                           'toolkit on the machine with the card')
    return path


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(b''.join(f.read_bytes() for f in [SOURCES[name], *_HEADERS])
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
            argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
            fns = (lib.dgsqp_chol_f32, lib.dgsqp_chol_f64)
        elif name == 'dyn_step':
            cd = ctypes.c_double
            argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, cd, cd, ctypes.POINTER(cd),
                        ctypes.POINTER(ci), vp, vp, ci, cd, cd, ci, vp, vp, vp, ci, vp]
            fns = (lib.dgsqp_dyn_step_f32, lib.dgsqp_dyn_step_f64)
        else:
            argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
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


def _smem_limit(index: int) -> int:
    if index not in _smem_limits:
        props = torch.cuda.get_device_properties(index)
        _smem_limits[index] = int(getattr(props, 'shared_memory_per_block_optin',
                                          SMEM_OPTIN_BYTES))
    return _smem_limits[index]


def _needs_attr(wrapper, key, smem: int) -> int:
    """1 if the kernel named by ``key`` must have its dynamic shared-memory limit raised
    to ``smem`` before this launch (first launch, or a larger size than any before)."""
    if smem <= _attr_smem.get(key, 0):
        return 0
    _attr_smem[key] = smem
    wrapper.attr_sets += 1
    return 1


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
def row_stride(n: int, itemsize: int) -> int:
    """Row stride of a matrix in the kernels' shared memory: the smallest multiple of 4
    not below n whose count of 16-byte chunks is odd (see ``csrc/common.cuh``)."""
    vec = 16 // itemsize
    r4 = (n + 3) & ~3
    return r4 if (r4 // vec) % 2 else r4 + vec


def chol_smem_bytes(n: int, itemsize: int) -> int:
    """The matrix plus the transposed panel buffer of ``chol.cu``."""
    return (n * row_stride(n, itemsize) + CHOL_PANEL * ((n + 3) & ~3)) * itemsize


def cho_solve_plan(n: int, k: int, itemsize: int):
    """Which kernel of ``cho_solve.cu`` solves k right-hand sides of size n:
    ``(path, width, smem_bytes)`` with path ``'warp'`` (width warps, one per column, in
    a block) or ``'column'`` (width threads, one per column, in a block).  A pure
    function of its arguments; no card is asked."""
    mat = n * row_stride(n, itemsize)
    if k <= WARP_PATH_MAX_K:
        width = min(k, WARP_PATH_WARPS)
        return 'warp', width, (mat + width * ((n + 31) & ~31)) * itemsize
    width = COLUMN_TILE
    if k <= 32 or (mat + n * width + n) * itemsize > SMEM_OPTIN_BYTES:
        width = 32
    return 'column', width, (mat + n * width + n) * itemsize


def cho_solve_smem_bytes(n: int, itemsize: int, k: int = 1) -> int:
    return cho_solve_plan(n, k, itemsize)[2]


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
    index = A.device.index or 0
    smem = chol_smem_bytes(n, A.element_size())
    if n > CHOL_MAX_N or smem > _smem_limit(index):
        raise ValueError(f'cholesky: n={n} in {A.dtype} does not fit in shared memory')
    L = torch.empty_like(A)
    if B == 0 or n == 0:
        return L
    lib = _load('chol')
    fn = lib.dgsqp_chol_f32 if A.dtype == torch.float32 else lib.dgsqp_chol_f64
    set_attr = _needs_attr(cholesky, ('chol', CHOL_PANEL, A.dtype, index), smem)
    rc = fn(A.data_ptr(), L.data_ptr(), B, n, CHOL_PANEL, row_stride(n, A.element_size()),
            smem, set_attr, index, torch.cuda.current_stream(A.device).cuda_stream)
    _raise_on(rc, 'cholesky')
    cholesky.launches += 1
    cholesky.launches_by_n[n] = cholesky.launches_by_n.get(n, 0) + 1
    return L


cholesky.launches = 0
cholesky.launches_by_n = {}
cholesky.attr_sets = 0
register_launches(cholesky, 'launches', 'launches_by_n')


def cho_solve(L, b):
    """Solve (L L') x = b for each batch element; L (B, n, n) lower, b (B, n) or
    (B, n, k).  A CPU tensor takes :func:`cho_solve_plain`; a CUDA tensor launches the
    kernel of ``cho_solve.cu`` that :func:`cho_solve_plan` names."""
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
    index = L.device.index or 0
    path, width, smem = cho_solve_plan(n, max(k, 1), L.element_size())
    if smem > _smem_limit(index):
        raise ValueError(f'cho_solve: n={n} in {L.dtype} does not fit in shared memory')
    x = torch.empty_like(b)
    if B == 0 or n == 0 or k == 0:
        return x
    lib = _load('cho_solve')
    fn = lib.dgsqp_cho_solve_f32 if L.dtype == torch.float32 else lib.dgsqp_cho_solve_f64
    set_attr = _needs_attr(cho_solve, ('cho_solve', path, L.dtype, index), smem)
    threads = width if path == 'column' else 32 * max(width, WARP_PATH_LOADERS)
    rc = fn(L.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, k, int(path == 'column'), width,
            threads, row_stride(n, L.element_size()), smem, set_attr, index,
            torch.cuda.current_stream(L.device).cuda_stream)
    _raise_on(rc, 'cho_solve')
    cho_solve.launches += 1
    cho_solve.launches_by_n[n] = cho_solve.launches_by_n.get(n, 0) + 1
    return x


cho_solve.launches = 0
cho_solve.launches_by_n = {}
cho_solve.attr_sets = 0
register_launches(cho_solve, 'launches', 'launches_by_n')
