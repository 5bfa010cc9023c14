"""Port parity for DGSQP v2 and the solvers' host interface, on the CPU in float64.

The integrator game of ``tests/test_dgsqp_v2.py`` goes through ``solve`` of the JAX
package's ``DGSQPV2`` and of the port's, for the cases of that file (NMS with a fast and
with a slow ``reg_decay``, ``reg=1e1``, ``nms=False``, the ``sum_obj_l1`` merit): the
same ``msg``, ``num_iters`` and ``qp_solves``, and ``u_sol``/``l_sol`` within 1e-8
(absolute).  DGSQP v1's ``solve`` and ``step`` on the flat machine (``nonmono_ls=True``;
the default parameters pick the nested machine, which is not ported and raises) agree
with the JAX package's in the same way, and ``step`` leaves the same shifted warm start
(1e-8).  The batch, chicane, indefinite-QP and approximate-hook cases are in
``test_torch_dgsqp_v2_batch.py``.
"""
import numpy as np
import pytest
import torch

from dgsqp_tpu.solvers.dgsqp import DGSQP as JaxDGSQP
from dgsqp_tpu.solvers.dgsqp_v2 import DGSQPV2 as JaxDGSQPV2
from dgsqp_tpu.solvers.solver_types import DGSQPParams as JaxDGSQPParams
from dgsqp_tpu.solvers.solver_types import DGSQPV2Params as JaxDGSQPV2Params
from dgsqp_tpu.types import VehicleState as JaxVehicleState
from dgsqp_torch.solvers.dgsqp import DGSQP
from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
from dgsqp_torch.solvers.solver_types import DGSQPParams, DGSQPV2Params
from dgsqp_torch.types import VehicleState

from test_torch_v2_games import DT, N, make_solvers, torch_game
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-8

CASES = {
    'nms_fast_decay': dict(reg=1e2, reg_decay=0.5, nms=True, nms_frequency=5,
                           nms_memory_size=3, sqp_iters=200, p_tol=1e-7, d_tol=1e-7,
                           merit_decrease=0.01),
    'nms_slow_decay': dict(reg=1e2, reg_decay=0.95, nms=True, nms_frequency=2,
                           nms_memory_size=3, sqp_iters=200, p_tol=1e-7, d_tol=1e-7,
                           merit_decrease=0.01),
    'reg_1e1': dict(reg=1e1, nms=True, sqp_iters=200, p_tol=1e-8, d_tol=1e-8),
    'no_nms': dict(reg=1.0, nms=False, sqp_iters=200, p_tol=1e-6, d_tol=1e-6,
                   merit_decrease_condition='armijo'),
    'sum_obj_l1': dict(reg=1e1, nms=True, sqp_iters=200, p_tol=1e-6, d_tol=1e-6,
                       merit_function='sum_obj_l1', merit_decrease_condition='armijo'),
}
EXPECTED_MSG = {'nms_fast_decay': 'conv_abs_tol', 'nms_slow_decay': 'conv_rel_tol'}


def _same_info(info_t, info_j):
    assert info_t['msg'] == info_j['msg']
    assert info_t['status'] == info_j['status']
    assert info_t['num_iters'] == info_j['num_iters']
    assert info_t['qp_solves'] == info_j['qp_solves']
    np.testing.assert_allclose(info_t['u_sol'], info_j['u_sol'], rtol=0, atol=ATOL)
    np.testing.assert_allclose(info_t['l_sol'], info_j['l_sol'], rtol=0, atol=ATOL)
    for k in ('p_feas', 'comp', 'stat'):
        np.testing.assert_allclose(info_t['cond'][k], info_j['cond'][k], rtol=0, atol=ATOL)


@pytest.mark.parametrize('case', list(CASES))
def test_v2_solve_matches_jax(case):
    kw = CASES[case]
    jsolver, tsolver = make_solvers(JaxDGSQPV2, JaxDGSQPV2Params(N=N, dt=DT, **kw),
                                    DGSQPV2, DGSQPV2Params(N=N, dt=DT, **kw))
    info_j = jsolver.solve([JaxVehicleState(), JaxVehicleState()])
    info_t = tsolver.solve([VehicleState(), VehicleState()])
    _same_info(info_t, info_j)
    assert info_t['msg'] == EXPECTED_MSG.get(case, info_t['msg'])
    assert info_t['msg'] in ('conv_abs_tol', 'conv_rel_tol')
    np.testing.assert_allclose(info_t['x_pred'], info_j['x_pred'], rtol=0, atol=ATOL)
    np.testing.assert_allclose(info_t['u_pred'], info_j['u_pred'], rtol=0, atol=ATOL)


def test_v1_solve_and_step_match_jax_on_the_flat_machine():
    kw = dict(reg=0.0, p_tol=1e-8, d_tol=1e-8, nonmono_ls=True)
    jsolver, tsolver = make_solvers(JaxDGSQP, JaxDGSQPParams(N=N, dt=DT, **kw),
                                    DGSQP, DGSQPParams(N=N, dt=DT, **kw))
    info_j = jsolver.solve([JaxVehicleState(), JaxVehicleState()])
    info_t = tsolver.solve([VehicleState(), VehicleState()])
    _same_info(info_t, info_j)
    assert info_t['msg'] == 'conv_abs_tol'
    np.testing.assert_allclose(info_t['cost'], info_j['cost'], rtol=0, atol=ATOL)
    np.testing.assert_allclose(info_t['init']['l'], info_j['init']['l'], rtol=0, atol=ATOL)

    # an MPC step: solve, apply the first input, shift the warm start
    states_j = [JaxVehicleState(), JaxVehicleState()]
    states_t = [VehicleState(), VehicleState()]
    for s in states_j + states_t:
        s.t = 0.5
    step_j = jsolver.step(states_j)
    step_t = tsolver.step(states_t)
    _same_info(step_t, step_j)
    np.testing.assert_allclose(tsolver.u_ws, jsolver.u_ws, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tsolver.u_prev, jsolver.u_prev, rtol=0, atol=ATOL)
    for s_t, s_j, pred_t, pred_j in zip(states_t, states_j, tsolver.get_prediction(),
                                        jsolver.get_prediction()):
        assert abs(s_t.u.u_a - s_j.u.u_a) <= ATOL
        assert pred_t.t == pred_j.t == 0.5
        np.testing.assert_allclose(pred_t.v_long, pred_j.v_long, rtol=0, atol=ATOL)
        np.testing.assert_allclose(pred_t.u_a, pred_j.u_a, rtol=0, atol=ATOL)


def test_unported_machines_raise():
    joint, costs, shared, bounds = torch_game()
    with pytest.raises(NotImplementedError):        # default parameters: nested machine
        DGSQP(joint, costs, [None, None], shared, bounds, DGSQPParams(N=N, dt=DT),
              print_method=None, dtype=torch.float64, device='cpu')
    v1 = DGSQP(joint, costs, [None, None], shared, bounds,
               DGSQPParams(N=N, dt=DT, nonmono_ls=True), print_method=None,
               dtype=torch.float64, device='cpu')
    z = torch.zeros(1, 1, dtype=torch.float64)
    with pytest.raises(NotImplementedError):        # traces the nested machine
        v1.solve_batch_traced(z, z, z, z)
