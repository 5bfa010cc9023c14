"""Port parity for DGSQP v1's nested machine, on the CPU in float64.

The nested machine (``_make_body``: an SQP iteration with a monotone Armijo line
search, or with the watchdog's loop of rounds inside it; damped BFGS) runs in the JAX
package under ``vmap`` of ``lax.while_loop`` and in the port on the whole batch with
per-game masks.  On the two-agent integrator games of ``tests/test_dgsqp.py`` (the LQ
games, one with a coupled constraint, one with an active input bound, and a game with
a ``tanh`` rivalry term whose merit makes the watchdog visit its insurance and fallback
modes), from warm starts drawn with numpy, both packages give the same per-game
statuses, iteration and QP-solve counts, and solutions within 1e-8; a float32 BFGS case
holds the float32 guards.  Beside them: the flat and the nested machine make the same
decisions, the stall escape under ``execution='nested'``, the nested
``solve_batch_chunked`` with its history, and the host ``solve`` with game parameters
on both machines.  (v1's ``solve_batch_traced`` on the chicane is held in
``test_torch_tooling.py``, beside the diagnosis built on it.)

The record that ``chip_smoke.py``'s ``nested_path`` holds the card to,
``dgsqp_torch/harness/data/nested_reference_f32.json``, is the JAX package's bench
batch (chicane, N=25, 256 games, seed 0) solved by the nested machine
(``DGSQP_BENCH_NMLS=0``, ``solve_batch_chunked(chunk_iters=8)``) in float32 on the CPU:
run this file as a script (``python tests/test_torch_nested.py --write-record``) to
write it; the ``slow`` test re-runs it and holds it to the file.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# run as a script (to write the record), the packages are found from the repo's root
sys.path.insert(0, str(ROOT))

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.dynamics import DynamicsConfig as JaxDynamicsConfig
from dgsqp_tpu.dynamics import IntegratorModel as JaxIntegratorModel
from dgsqp_tpu.dynamics import MultiAgentDynamicsModel as JaxMultiAgent
from dgsqp_tpu.solvers.dgsqp import DGSQP as JaxDGSQP
from dgsqp_tpu.solvers.solver_types import DGSQPParams as JaxDGSQPParams
from dgsqp_tpu.types import VehicleState as JaxVehicleState
from dgsqp_torch import interop
from dgsqp_torch.solvers import dgsqp as dgsqp_mod
from dgsqp_torch.dynamics import DynamicsConfig, IntegratorModel, MultiAgentDynamicsModel
from dgsqp_torch.solvers.dgsqp import (DGSQP, DIVERGED, RUNNING, STALLED, SQPResult,
                                       WD_FB, WD_INS2)
from dgsqp_torch.solvers.solver_types import DGSQPParams
from dgsqp_torch.types import VehicleState

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

RECORD = ROOT / 'dgsqp_torch' / 'harness' / 'data' / 'nested_reference_f32.json'
RECORD_GAMES, RECORD_SEED, RECORD_CHUNK = 256, 0, 8
RECORD_ENV = {'DGSQP_BENCH_NMLS': '0'}


N, DT, B = 5, 0.1, 8
ATOL = 1e-8

# the games of tests/test_dgsqp.py: the unconstrained LQ game, the coupled progress cap,
# the active input bound; and a rivalry term tanh(2 (x_a - x_b)) whose merit is not
# monotone along full steps (the watchdog's insurance and fallback rounds)
LQ = dict(gamma=0.2)
COUPLED = dict(gamma=0.3, coupled=True, w_term=100.0, u_lim=5.0)
INPUT_BOUND = dict(gamma=0.0, u_lim=0.05, w_term=100.0)
RIVALRY = dict(gamma=0.0, tanh=10.0, sharp=2.0, u_lim=5.0)
# a milder rivalry for BFGS: its line searches succeed, so every update is made from a
# step well above rounding (after a failed search the step is tau^49 ~ 1e-14 long, and
# an update from it is rounding in either package)
MILD = dict(gamma=0.3, tanh=1.0, sharp=2.0, u_lim=5.0)
# their solver parameters: tests/test_dgsqp.py's defaults (Armijo), the nested watchdog
# and damped BFGS
ARMIJO = dict(reg=0.0, p_tol=1e-8, d_tol=1e-8, sqp_iters=50)
WATCHDOG = dict(reg=1e-3, p_tol=1e-8, d_tol=1e-8, sqp_iters=50, nonmono_ls=True, beta=0.01,
                tau=0.5, execution='nested')
BFGS = dict(reg=1e-6, p_tol=1e-7, d_tol=1e-7, sqp_iters=100, hessian_approximation='bfgs')
CASES = {
    'armijo_lq': (LQ, ARMIJO),
    'armijo_coupled': (COUPLED, dict(ARMIJO, reg=1e-3)),
    'armijo_input_bound': (INPUT_BOUND, ARMIJO),
    'armijo_rivalry': (RIVALRY, dict(ARMIJO, reg=1e-3)),
    'watchdog_coupled': (COUPLED, dict(WATCHDOG, p_tol=1e-6, d_tol=1e-6)),
    'watchdog_rivalry': (RIVALRY, WATCHDOG),
    'bfgs_lq': (LQ, BFGS),
    'bfgs_mild': (MILD, BFGS),
}


def integrator_game(pkg, gamma=0.2, u_lim=50.0, coupled=False, w_term=1.0, tanh=0.0,
                    sharp=1.0, param=False):
    """(joint, costs, agent constraints, shared constraints, bounds) of the two-agent
    integrator game in the JAX package (``pkg='jax'``) or the port; with ``param`` the
    terminal costs take a game parameter P and add ``P * x_a``."""
    jx = pkg == 'jax'
    model, cfg, joint_cls, state = (
        (JaxIntegratorModel, JaxDynamicsConfig, JaxMultiAgent, JaxVehicleState) if jx
        else (IntegratorModel, DynamicsConfig, MultiAgentDynamicsModel, VehicleState))
    joint = joint_cls(0.0, [model(0.0, cfg(dt=DT)), model(0.0, cfg(dt=DT))])
    X = (lambda x, i: x[i]) if jx else (lambda x, i: x[..., i])
    th = jnp.tanh if jx else torch.tanh

    def stage(x, u, um):
        return 0.5 * X(u, 0) ** 2

    def term(a):
        def cost(x):
            return (0.5 * w_term * (X(x, a) - 1.0) ** 2 + gamma * X(x, 0) * X(x, 1)
                    + tanh * th(sharp * (X(x, a) - X(x, 1 - a))))
        if param:
            return lambda x, P: cost(x) + P * X(x, a)
        return cost

    shared = None
    if coupled:
        if jx:
            cap = lambda x: jnp.array([x[0] + x[1] - 1.0])
        else:
            cap = lambda x: (x[..., 0] + x[..., 1] - 1.0)[..., None]
        shared = [None] + [lambda x, u, um: cap(x)] * (N - 1) + [cap]
    ub, lb = state(), state()
    ub.v.v_long, ub.u.u_a = np.inf, u_lim
    lb.v.v_long, lb.u.u_a = -np.inf, -u_lim
    bounds = {'ub': [ub, ub.copy()], 'lb': [lb, lb.copy()]}
    return joint, [(stage, term(0)), (stage, term(1))], [None, None], shared, bounds


def make_solvers(game_kw, params_kw, dtype=torch.float64, jax_dtype=None):
    jsolver = JaxDGSQP(*integrator_game('jax', **game_kw),
                       JaxDGSQPParams(N=N, dt=DT, **params_kw), print_method=None,
                       dtype=jax_dtype)
    tsolver = DGSQP(*integrator_game('torch', **game_kw), DGSQPParams(N=N, dt=DT, **params_kw),
                    print_method=None, dtype=dtype, device='cpu')
    return jsolver, tsolver


def draw_batch(n_c, seed=11, games=B):
    """Initial states and warm starts drawn with numpy: (u0, l0, x0, up)."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.5, 0.5, (games, 2))
    u0 = rng.normal(0.0, 1.0, (games, 2 * N))
    return u0, np.zeros((games, n_c)), x0, np.zeros((games, 2))


def assert_same_result(res_t, res_j, atol=ATOL):
    res_j = interop.to_torch_tuple(res_j, SQPResult, device='cpu')
    for f in ('status', 'iters', 'qp_solves'):
        assert torch.equal(getattr(res_t, f).long(), getattr(res_j, f).long()), \
            (f, getattr(res_t, f).tolist(), getattr(res_j, f).tolist())
    alive = res_j.status != DIVERGED
    for f in ('u', 'l', 'p_feas', 'comp', 'stat'):
        np.testing.assert_allclose(getattr(res_t, f)[alive].double().numpy(),
                                   getattr(res_j, f)[alive].double().numpy(),
                                   rtol=0, atol=atol, err_msg=f)


@pytest.fixture(scope='module')
def solved():
    """Every case solved by both packages: {case: (port solver, batch, port result)}."""
    out = {}
    for case, (game_kw, params_kw) in CASES.items():
        jsolver, tsolver = make_solvers(game_kw, params_kw)
        batch = draw_batch(tsolver.n_c)
        res_j = jsolver._solve_batch_jit(*(jnp.asarray(a) for a in batch), None)
        res_t = tsolver._solve_core(*interop.bench_batch(*batch, device='cpu'))
        out[case] = (tsolver, batch, res_t, res_j)
    return out


@pytest.mark.parametrize('case', list(CASES))
def test_nested_machine_matches_jax(solved, case):
    tsolver, _, res_t, res_j = solved[case]
    assert not tsolver._use_flat()
    assert_same_result(res_t, res_j)
    assert (res_t.status != RUNNING).all()


def test_watchdog_visits_its_insurance_and_fallback_rounds(solved):
    """The rivalry game's full steps raise the merit: the watchdog's insurance and
    fallback rounds run (and add QP solves to the iterations')."""
    tsolver, batch, res_t, _ = solved['watchdog_rivalry']
    modes = set()
    select = dgsqp_mod._sel_tree

    def spy(mask, new, old):
        if isinstance(old, dgsqp_mod._WatchdogCarry):
            modes.update(old.mode[mask].tolist())
        return select(mask, new, old)

    dgsqp_mod._sel_tree = spy
    try:
        again = tsolver._solve_core(*interop.bench_batch(*batch, device='cpu'))
    finally:
        dgsqp_mod._sel_tree = select
    assert {WD_INS2, WD_FB} <= modes
    assert (res_t.qp_solves > res_t.iters).any()
    assert torch.equal(again.status, res_t.status)


@pytest.mark.parametrize('case', ['watchdog_coupled', 'watchdog_rivalry'])
def test_flat_and_nested_make_the_same_decisions(solved, case):
    """The flat round machine (``execution='flat'``) reaches the nested watchdog's
    statuses, iterations, QP solves and solutions."""
    tsolver, batch, res_n, _ = solved[case]
    game_kw, params_kw = CASES[case]
    flat = DGSQP(*integrator_game('torch', **game_kw),
                 DGSQPParams(N=N, dt=DT, **dict(params_kw, execution='flat')),
                 print_method=None, dtype=torch.float64, device='cpu')
    assert flat._use_flat()
    res_f = flat._solve_core(*interop.bench_batch(*batch, device='cpu'))
    for f in ('status', 'iters', 'qp_solves'):
        assert torch.equal(getattr(res_f, f), getattr(res_n, f)), f
    np.testing.assert_allclose(res_f.u.numpy(), res_n.u.numpy(), rtol=0, atol=ATOL)


def test_stall_escape_nested():
    """``stall_its`` under ``execution='nested'``: games that stop improving end
    ``stalled``, the others conv_rel, as in the JAX package."""
    jsolver, tsolver = make_solvers(RIVALRY, dict(WATCHDOG, stall_its=3))
    batch = draw_batch(tsolver.n_c)
    res_j = jsolver._solve_batch_jit(*(jnp.asarray(a) for a in batch), None)
    res_t = tsolver._solve_core(*interop.bench_batch(*batch, device='cpu'))
    assert_same_result(res_t, res_j)
    assert (res_t.status == STALLED).any() and (res_t.status != STALLED).any()


def test_bfgs_float32_matches_jax():
    """Damped BFGS in float32: the 1e-300 guards are 0 in float32 in both packages."""
    params = dict(BFGS, p_tol=1e-4, d_tol=1e-4)
    jsolver, tsolver = make_solvers(MILD, params, dtype=torch.float32,
                                    jax_dtype=jnp.float32)
    batch = [a.astype(np.float32) for a in draw_batch(tsolver.n_c)]
    res_j = jsolver._solve_batch_jit(*(jnp.asarray(a) for a in batch), None)
    res_t = tsolver._solve_core(*interop.bench_batch(*batch, dtype=torch.float32,
                                                     device='cpu'))
    assert res_t.u.dtype == torch.float32
    assert_same_result(res_t, res_j, atol=1e-4)


def test_nested_chunked_matches_jax(solved):
    """The nested ``solve_batch_chunked`` (chunks of iterations, fixed layout) gives
    the one-loop result and the JAX package's chunk history."""
    game_kw, params_kw = CASES['bfgs_mild']
    jsolver, tsolver = make_solvers(game_kw, params_kw)
    batch = draw_batch(tsolver.n_c)
    res_j = jsolver.solve_batch_chunked(*(jnp.asarray(a) for a in batch), chunk_iters=3)
    res_t = tsolver.solve_batch_chunked(*interop.bench_batch(*batch, device='cpu'),
                                        chunk_iters=3)
    assert_same_result(res_t, res_j)
    for f, a in zip(SQPResult._fields, solved['bfgs_mild'][2]):
        assert torch.equal(getattr(res_t, f), a), f
    hist_j, hist_t = jsolver.last_chunk_history, tsolver.last_chunk_history
    assert len(hist_t) == len(hist_j) > 1
    for h_t, h_j in zip(hist_t, hist_j):
        assert (h_t['chunk'], h_t['running']) == (h_j['chunk'], h_j['running'])
        assert h_t['batch'] == B
        np.testing.assert_allclose([h_t['iters_p50'], h_t['stat_p50']],
                                   [h_j['iters_p50'], h_j['stat_p50']], rtol=1e-8)


@pytest.mark.parametrize('machine', ['nested', 'flat'])
def test_host_solve_with_parameters(machine):
    """``solve(states, parameters)`` on a parameterised game: the dual warm start, the
    solve and the costs take the parameters, on both machines."""
    params_kw = dict(ARMIJO, reg=1e-3) if machine == 'nested' else \
        dict(WATCHDOG, execution='flat')
    game_kw = dict(RIVALRY, param=True)
    jsolver, tsolver = make_solvers(game_kw, params_kw)
    assert tsolver._use_flat() == (machine == 'flat')
    u_ws = np.random.default_rng(5).normal(0.0, 1.0, (N, 2))
    jsolver.set_warm_start(u_ws)
    tsolver.set_warm_start(u_ws)
    info_j = jsolver.solve([JaxVehicleState(), JaxVehicleState()], 0.3)
    info_t = tsolver.solve([VehicleState(), VehicleState()], 0.3)
    assert info_t['msg'] == info_j['msg']
    assert info_t['msg'] in ('conv_abs_tol', 'conv_rel_tol')
    assert (info_t['num_iters'], info_t['qp_solves']) == (info_j['num_iters'],
                                                         info_j['qp_solves'])
    for key in ('u_sol', 'l_sol', 'cost'):
        np.testing.assert_allclose(info_t[key], info_j[key], rtol=0, atol=ATOL, err_msg=key)
    np.testing.assert_allclose(info_t['init']['l'], info_j['init']['l'], rtol=0, atol=ATOL)
    # the parameters move the equilibrium
    info_0 = tsolver.solve([VehicleState(), VehicleState()], 0.0)
    assert np.abs(info_0['u_sol'] - info_t['u_sol']).max() > 1e-3


def jax_nested_record(games=RECORD_GAMES, verbose=False):
    """The JAX package's bench batch on the nested machine, float32 on the CPU (the
    caller has turned x64 off): per-game statuses, iterations and QP solves."""
    import numpy as np
    os.environ.update(RECORD_ENV)
    from dgsqp_tpu.harness.bench_setup import build_bench_batch, build_bench_solver
    from dgsqp_tpu.solvers.dgsqp import STATUS_MSG
    sc, solver = build_bench_solver(horizon=25)
    batch = build_bench_batch(sc, solver, games, seed=RECORD_SEED)
    t0 = time.time()
    res = solver.solve_batch_chunked(*batch, chunk_iters=RECORD_CHUNK, verbose=verbose)
    seconds = time.time() - t0
    status = np.asarray(res.status)
    return dict(command='python tests/test_torch_nested.py --write-record',
                package='dgsqp_tpu', device='cpu', dtype=str(solver.dtype.__name__),
                env=RECORD_ENV, horizon=25, games=games, seed=RECORD_SEED,
                chunk_iters=RECORD_CHUNK, execution='nested' if not solver._use_flat()
                else 'flat', seconds=seconds,
                status_counts={STATUS_MSG[int(s)]: int((status == s).sum())
                               for s in np.unique(status)},
                status=[int(s) for s in status], iters=np.asarray(res.iters).tolist(),
                qp_solves=np.asarray(res.qp_solves).tolist(),
                chunks=len(solver.last_chunk_history))


@pytest.mark.slow
def test_nested_record_matches_jax(tmp_path):
    """The committed record is what the JAX package computes now (its writer runs in a
    process of its own: the record is float32, the tests' JAX is float64)."""
    out = tmp_path / 'nested_record.json'
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()), '--write-record',
                          str(out)], cwd=ROOT, capture_output=True, text=True, timeout=3000,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    new, rec = json.loads(out.read_text()), json.loads(RECORD.read_text())
    for k in ('games', 'seed', 'chunk_iters', 'env', 'dtype', 'execution', 'status_counts',
              'status', 'iters', 'qp_solves'):
        assert new[k] == rec[k], k


def _write_record_main(out: Path):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', False)
    rec = jax_nested_record(verbose=True)
    out.write_text(json.dumps(rec) + '\n')
    print(f'wrote {out} ({rec["seconds"]:.0f} s): {rec["status_counts"]}')


if __name__ == '__main__':
    if sys.argv[1:2] != ['--write-record'] or len(sys.argv) > 3:
        sys.exit('usage: python tests/test_torch_nested.py --write-record [OUT]')
    _write_record_main(Path(sys.argv[2]) if len(sys.argv) == 3 else RECORD)
