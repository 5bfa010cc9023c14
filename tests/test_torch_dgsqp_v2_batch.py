"""Port parity for batched DGSQP v2, on the CPU in float64: the same inputs, made from a
seed with numpy, through ``dgsqp_tpu`` and the port.

A batch of 24 integrator games (``rng`` seed 3), of which 16 start from their solution
(they end in round 0) and 8 from the random point, so that the batch holds ended and
running games side by side and the compaction has stragglers to gather:

* the carries after ``_init_carry`` and after each of the first 12 rounds, from JAX's
  ``_chunk(..., chunk_iters=1)`` under ``vmap`` and from the port's round, agree field by
  field: integers and booleans are equal, floats agree within 1e-9 relative (plus 1e-11
  absolute for values that are zero up to rounding) with ``inf`` where ``inf``.  One
  exception, stated in the port's module docstring: for a game that has ended,
  ``delta``, ``reg`` and ``ck_delta`` are not compared (the JAX round still lets them
  fall back to the checkpoint's values; nothing reads them);
* ``solve_batch_chunked`` with ``_compact_min_bucket = 4`` equals the uncompacted run
  (statuses and counts equal, floats within 1e-12) and the JAX package's result
  (statuses and counts equal, floats within 1e-8);
* ``solve_batch_traced`` records the same statuses and counts per round as the JAX
  package's, floats within 1e-9 relative.

The chicane bench problem at N = 5, batch 4, ``solver_name='v2'``: the bench batch agrees
within 1e-10, per-game status, ``iters`` and ``qp_solves`` are equal, ``u`` and the
convergence measures agree within 1e-6.

The indefinite-QP, max-merit and approximate-hook cases are in
``test_torch_dgsqp_v2_variants.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.harness.bench_setup import build_bench_batch as jax_batch
from dgsqp_tpu.harness.bench_setup import build_bench_solver as jax_solver
from dgsqp_tpu.solvers.dgsqp_v2 import DGSQPV2 as JaxDGSQPV2
from dgsqp_tpu.solvers.solver_types import DGSQPV2Params as JaxDGSQPV2Params
from dgsqp_torch import interop
from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
from dgsqp_torch.solvers.dgsqp import RUNNING, SQPResult
from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2, _CarryV2
from dgsqp_torch.solvers.solver_types import DGSQPV2Params

from test_torch_v2_games import DT, N, make_solvers
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

B = 24     # not a power of two, so that the compaction pads its bucket
ROUNDS = 12
# a fast-decaying regularization and a short first trust radius: the random games need
# 15 to 18 rounds, through d-steps and m-steps
BASE = dict(reg=3.0, reg_decay=0.6, nms=True, nms_frequency=3,
            nms_initial_step_size_factor=1.0, sqp_iters=200, p_tol=1e-7, d_tol=1e-7)
UNREAD_ONCE_ENDED = ('delta', 'reg', 'ck_delta')


def _solvers(param_cost=False, **kw):
    kw = {**BASE, **kw}
    return make_solvers(JaxDGSQPV2, JaxDGSQPV2Params(N=N, dt=DT, **kw),
                        DGSQPV2, DGSQPV2Params(N=N, dt=DT, **kw), param_cost=param_cost)


def _batch(jsolver):
    rng = np.random.default_rng(3)
    u0 = rng.normal(0, 0.1, (B, jsolver.n_dec))
    x0 = rng.normal(0, 0.3, (B, jsolver.n_q))
    up = np.zeros((B, jsolver.n_u))

    def dws(u, x, p):
        P = jsolver._approx_update(u, x) if jsolver._approx_update is not None else None
        return jsolver.problem.dual_warm_start(u, x, p, P)
    l0 = np.asarray(jax.jit(jax.vmap(dws))(jnp.asarray(u0), jnp.asarray(x0), jnp.asarray(up)))
    return u0, l0, x0, up


def _same_result(res_t, res_j, atol):
    res_j = interop.to_torch_tuple(res_j, SQPResult, device='cpu')
    for f in ('status', 'iters', 'qp_solves'):
        assert torch.equal(getattr(res_t, f).long(), getattr(res_j, f).long()), f
    for f in ('u', 'l', 'p_feas', 'comp', 'stat'):
        np.testing.assert_allclose(getattr(res_t, f).numpy(), getattr(res_j, f).numpy(),
                                   rtol=0, atol=atol, err_msg=f)


def _solve_both(jsolver, tsolver, batch, atol=1e-8, **kw):
    res_j = jsolver.solve_batch_chunked(*(jnp.asarray(a) for a in batch), compact=False, **kw)
    res_t = tsolver.solve_batch_chunked(*interop.bench_batch(*batch, device='cpu'),
                                        compact=False, **kw)
    _same_result(res_t, res_j, atol)
    return res_t


@pytest.fixture(scope='module')
def integrator():
    jsolver, tsolver = _solvers()
    batch = _batch(jsolver)
    # one jitted round, reused by the round-by-round case and by solve_batch_chunked
    jsolver._chunk_jit = jax.jit(jax.vmap(
        lambda c, x, u_p: jsolver._chunk(c, x, u_p, None, 1)))
    jsolver._init_jit = jax.jit(jax.vmap(
        lambda u, l, x, u_p: jsolver._init_carry(u, l, x, u_p, None)))
    jsolver._final_jit = jax.jit(jax.vmap(
        lambda c, x, u_p: jsolver._finalize(c, x, u_p, None)))
    # two games in three start from their solution
    u0, l0, x0, up = batch
    sol = jsolver.solve_batch_chunked(*(jnp.asarray(a) for a in batch), chunk_iters=1,
                                      compact=False)
    warm = np.arange(B) % 3 != 0
    u0 = np.where(warm[:, None], np.asarray(sol.u), u0)
    l0 = np.where(warm[:, None], np.asarray(sol.l), l0)
    return jsolver, tsolver, (u0, l0, x0, up)


def _assert_carries_agree(c_t, c_j, where):
    a, b = interop.fields_to_numpy(c_t), interop.fields_to_numpy(c_j)
    ended = b['status'] != RUNNING
    for f in _CarryV2._fields:
        x, y = a[f], b[f]
        if f in UNREAD_ONCE_ENDED:
            x, y = x[~ended], y[~ended]
        if y.dtype.kind in 'biu':
            np.testing.assert_array_equal(x.astype(np.int64), y.astype(np.int64),
                                          err_msg=f'{f} {where}')
        else:
            np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-11, err_msg=f'{f} {where}')


def test_rounds_match_jax_field_by_field(integrator):
    jsolver, tsolver, batch = integrator
    args_j = tuple(jnp.asarray(a) for a in batch)
    u0, l0, x0, up = interop.bench_batch(*batch, device='cpu')
    c_j = jsolver._init_jit(*args_j)
    c_t = tsolver._init_carry(u0, l0, x0, up)
    _assert_carries_agree(c_t, c_j, 'after init')
    body = tsolver._make_body(x0, up)
    seen = set()
    for r in range(ROUNDS):
        c_j = jsolver._chunk_jit(c_j, args_j[2], args_j[3])
        c_t = body(c_t)
        _assert_carries_agree(c_t, c_j, f'after round {r}')
        seen.update(c_t.status.tolist())
    # the carry crosses over as it is: the JAX carry continues in the port's round
    c_x = interop.to_torch_tuple(c_j, _CarryV2, device='cpu')
    _assert_carries_agree(body(c_x), jsolver._chunk_jit(c_j, args_j[2], args_j[3]),
                          'after a round on the carried-over carry')
    assert seen == {0, 1} and int(c_t.m_it.max()) > 0 and int(c_t.ck_counter.max()) > 0


def test_chunked_solve_matches_jax_and_compaction_changes_nothing(integrator):
    jsolver, tsolver, batch = integrator
    res_fixed = _solve_both(jsolver, tsolver, batch, chunk_iters=1)
    assert all(h['batch'] == B for h in tsolver.last_chunk_history)
    tsolver._compact_min_bucket = 4
    try:
        res_comp = tsolver.solve_batch_chunked(*interop.bench_batch(*batch, device='cpu'),
                                               chunk_iters=8)
    finally:
        del tsolver._compact_min_bucket
    for f in SQPResult._fields:
        a, b = getattr(res_fixed, f), getattr(res_comp, f)
        if a.is_floating_point():
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-12, err_msg=f)
        else:
            assert torch.equal(a, b), f
    sizes = [h['batch'] for h in tsolver.last_chunk_history]
    assert sizes[0] == B and min(sizes) <= 8
    assert not (res_comp.status == RUNNING).any()


def test_traced_solve_matches_jax(integrator):
    jsolver, tsolver, batch = integrator
    T = 6
    res_j, trace_j = jsolver.solve_batch_traced(*(jnp.asarray(a) for a in batch), None,
                                                num_iters=T, record_iterates=True)
    res_t, trace_t = tsolver.solve_batch_traced(*interop.bench_batch(*batch, device='cpu'),
                                                num_iters=T, record_iterates=True)
    assert set(trace_t) == set(trace_j)
    for k in ('status', 'it', 'qp_solves'):
        np.testing.assert_array_equal(trace_t[k].numpy(), np.asarray(trace_j[k]), err_msg=k)
    for k in ('p_feas', 'comp', 'stat', 'du_norm', 'dl_norm', 'u', 'l'):
        np.testing.assert_allclose(trace_t[k].numpy(), np.asarray(trace_j[k]), rtol=1e-9,
                                   atol=1e-11, err_msg=k)
    assert trace_t['u'].shape == (B, T, tsolver.n_dec)
    _same_result(res_t, res_j, 1e-8)


def test_chicane_bench_v2_matches_jax():
    n_h, batch_size = 5, 4
    jsc, jsolver = jax_solver(horizon=n_h, solver_name='v2')
    batch = tuple(np.asarray(a) for a in jax_batch(jsc, jsolver, batch_size, seed=0))
    sc, solver = build_bench_solver(horizon=n_h, solver_name='v2', dtype=torch.float64,
                                    device='cpu')
    assert isinstance(solver, DGSQPV2) and solver.params == DGSQPV2Params(
        **{**solver.params.__dict__})
    # both packages query bit-identical track tables
    interop.load_track_tables(sc.track, np.asarray(jsc.track._kp),
                              np.asarray(jsc.track._cum_angle))
    for a_j, a_t in zip(batch, build_bench_batch(sc, solver, batch_size, seed=0)):
        np.testing.assert_allclose(a_t.numpy(), a_j, rtol=0, atol=1e-10)
    res_j = jsolver.solve_batch_chunked(*(jnp.asarray(a) for a in batch), chunk_iters=4)
    res_t = solver.solve_batch_chunked(*interop.bench_batch(*batch, device='cpu'),
                                       chunk_iters=4)
    _same_result(res_t, res_j, 1e-6)
    assert not (res_t.status == RUNNING).any()
    for f in ('reg', 'nms_frequency', 'nms_memory_size', 'sqp_iters', 'stall_its',
              'conv_method', 'qp_box_split', 'qp_correctors', 'line_search_iters'):
        assert getattr(solver.params, f) == getattr(jsolver.params, f), f
