"""Port parity for DGSQP v2's variants, on the CPU in float64: the same inputs, made from
a seed with numpy, through ``dgsqp_tpu`` and the port's ``solve_batch_chunked``.

* ``conv_method='none'`` (indefinite QP) and ``merit_decrease_condition='max'`` on a
  batch of 24 integrator games (``rng`` seed 3): statuses and counts equal, floats
  within 1e-8.
* A toy ``_approx_update`` set on both solvers with ``approximation_eval='always'``:
  the same.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.solvers.dgsqp_v2 import DGSQPV2 as JaxDGSQPV2
from dgsqp_tpu.solvers.solver_types import DGSQPV2Params as JaxDGSQPV2Params
from dgsqp_torch import interop
from dgsqp_torch.solvers.dgsqp import RUNNING, SQPResult
from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
from dgsqp_torch.solvers.solver_types import DGSQPV2Params

from test_torch_v2_games import DT, N, make_solvers
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

B = 24
BASE = dict(reg=1.0, reg_decay=0.5, nms=True, nms_frequency=3, sqp_iters=200, p_tol=1e-7,
            d_tol=1e-7)


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


@pytest.mark.parametrize('kw', [dict(conv_method='none', reg=0.1, reg_decay=0.7, nms_frequency=2),
                                dict(merit_decrease_condition='max')],
                         ids=['indefinite_qp', 'max_merit_condition'])
def test_variants_match_jax(kw):
    jsolver, tsolver = _solvers(**kw)
    res = _solve_both(jsolver, tsolver, _batch(jsolver))
    assert not (res.status == RUNNING).any()


def test_approx_update_hook_matches_jax():
    """A toy parameter hook P(u) that the terminal costs read, re-evaluated at every
    trial point ('always'), set on both solvers."""
    jsolver, tsolver = _solvers(param_cost=True, approximation_eval='always')
    jsolver._approx_update = lambda u, x0: 0.1 * jnp.tanh(jnp.sum(u) + x0[0])
    tsolver._approx_update = lambda u, x0: 0.1 * torch.tanh(u.sum(-1) + x0[:, 0])
    res = _solve_both(jsolver, tsolver, _batch(jsolver))
    assert not (res.status == RUNNING).any()
