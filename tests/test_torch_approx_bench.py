"""Port parity for the approximate duel's bench configuration on the CPU in float64:
``build_bench_solver(solver_name='approx')`` at N=5 and its 4-game seed-0 batch in
``dgsqp_tpu`` and the port: the same parameters (the QP tolerance by dtype), the bench
batch within 1e-10 (with the P-aware dual warm start), and one chunk of 4 rounds with
the same per-game statuses and counts, u within 1e-6.
"""
import numpy as np
import jax.numpy as jnp
import torch

from dgsqp_tpu.harness.bench_setup import build_bench_batch as jax_batch
from dgsqp_tpu.harness.bench_setup import build_bench_solver as jax_solver
from dgsqp_torch import interop
from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
from dgsqp_torch.solvers.dgsqp_v2_frenet import DGSQPV2FrenetApprox

from test_torch_approx_duel import N, _same_result, share_geometry
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)


def test_bench_chunk_matches_jax():
    jsc, jsolver = jax_solver(horizon=N, solver_name='approx')
    sc, solver = build_bench_solver(horizon=N, solver_name='approx', dtype=torch.float64,
                                    device='cpu')
    assert isinstance(solver, DGSQPV2FrenetApprox) and solver._approx_update is None
    assert solver.params.__dict__ == {**jsolver.params.__dict__, 'qp_tol': 1e-8,
                                      'qp_interface': solver.params.qp_interface}
    share_geometry(jsc, sc)
    batch = tuple(np.asarray(a) for a in jax_batch(jsc, jsolver, 4, seed=0))
    batch_t = build_bench_batch(sc, solver, 4, seed=0)
    for a_j, a_t in zip(batch, batch_t):
        np.testing.assert_allclose(a_t.numpy(), a_j, rtol=0, atol=1e-10)
    kw = dict(chunk_iters=4, max_chunks=1, compact=False)
    res_j = jsolver.solve_batch_chunked(*(jnp.asarray(a) for a in batch), **kw)
    res_t = solver.solve_batch_chunked(*interop.bench_batch(*batch, device='cpu'), **kw)
    _same_result(res_t, res_j)
