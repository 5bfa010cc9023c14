"""Port parity for ``DGSQPV2FrenetApprox`` on the CPU in float64: the solver in
``'exact'`` mode (``'once'`` and ``'always'`` in ``test_torch_approx_solver_frozen.py``),
with the parameters of ``tests/test_frenet_approx.py``, on the x0 of that file and a
second, shifted game, through ``solve_batch_chunked`` of the JAX package and of the port:
per-game status, ``iters`` and ``qp_solves`` equal, u within 1e-6.  Both read
bit-identical geometry (``share_geometry`` of ``test_torch_approx_duel.py``).
"""
import jax.numpy as jnp
import numpy as np

from dgsqp_torch import interop
from dgsqp_torch.solvers.dgsqp import RUNNING

from test_torch_approx_duel import X0, _same_result, _solvers
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)


def check_solver_matches_jax(mode):
    js, ts = _solvers(mode)
    x0 = np.stack([X0, X0 + np.array([0.2, 0.1, 0.3, 0.05, 0.2, -0.1, 0.1, -0.2, 0.0, -0.1])])
    B = x0.shape[0]
    batch = (np.zeros((B, ts.n_dec)), np.zeros((B, ts.n_c)), x0, np.zeros((B, 6)))
    res_j = js.solve_batch_chunked(*(jnp.asarray(a) for a in batch), compact=False)
    res_t = ts.solve_batch_chunked(*interop.bench_batch(*batch, device='cpu'), compact=False)
    _same_result(res_t, res_j)
    assert not (res_t.status == RUNNING).any()
    if mode == 'exact':
        assert (res_t.status == 1).all()


def test_exact_mode_solver_matches_jax():
    check_solver_matches_jax('exact')
