"""The CUDA wrappers of ``dgsqp_torch.ops.linalg``: launch counting and input checks.

The kernels are held against their plain versions, at every main-path shape, by the
``kernels`` phase of ``chip_smoke.py``; these tests cover what that phase does not.  They
need an NVIDIA GPU and ``nvcc`` (marker ``cuda``) and skip elsewhere.  The file imports
no JAX; on a machine with the port's requirements only, skip the JAX ``conftest.py`` and
the xdist options of ``pytest.ini``:

    python -m pytest --noconftest -o addopts= -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from dgsqp_torch.ops import linalg


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_cuda_wrappers_count_launches_and_reject_bad_layout(dtype):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    A = (torch.eye(8, dtype=dtype, device='cuda') * 4.0).expand(3, 8, 8).contiguous()
    b = torch.ones(3, 8, dtype=dtype, device='cuda')
    n_chol, n_solve = linalg.cholesky.launches, linalg.cho_solve.launches
    L = linalg.cholesky(A)
    x = linalg.cho_solve(L, b)
    assert (linalg.cholesky.launches, linalg.cho_solve.launches) == (n_chol + 1, n_solve + 1)
    assert torch.equal(L, 2.0 * torch.eye(8, dtype=dtype, device='cuda').expand(3, 8, 8))
    assert torch.equal(x, torch.full_like(b, 0.25))
    with pytest.raises(ValueError):
        linalg.cholesky(A.transpose(-1, -2))                    # not contiguous
    with pytest.raises(ValueError):
        linalg.cho_solve(L, b.to(torch.float16))                # dtype differs from L
    assert (linalg.cholesky.launches, linalg.cho_solve.launches) == (n_chol + 1, n_solve + 1)


@pytest.mark.cuda
def test_cuda_kernel_rejects_oversized_matrix():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    A = torch.eye(200, dtype=torch.float64, device='cuda')[None]
    with pytest.raises(ValueError):
        linalg.cholesky(A)
