"""Port parity: the MCP oracle's FB-Newton and Josephy-Newton cores on the chicane duel
at N=5 (n=20 decisions), on the CPU in float64.

Four games of the JAX sampler (seed 0) with the JAX package's PID and dual warm
starts, the same track tables in both packages; the oracle's configuration
(tol 1e-3, 4 restarts) capped at 40 iterations a phase: every carry field after each of
the first 5 iterations (:func:`test_torch_mcp.compare_carries`), then status and
iterations equal and ``u``/``l`` within 1e-8 of each field's scale.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.harness.mc_study import _sample as jax_sample
from dgsqp_tpu.harness.scenarios import build_chicane_scenario as jax_chicane
from dgsqp_tpu.harness.warm_start import seed_virtual_rate_prev as jax_seed_up
from dgsqp_tpu.solvers.mcp import PATHMCP as JaxPATHMCP
from dgsqp_tpu.solvers.solver_types import PATHMCPParams as JaxParams
from dgsqp_torch import interop
from dgsqp_torch.harness.scenarios import build_chicane_scenario
from dgsqp_torch.solvers.mcp import RUNNING, PATHMCP
from dgsqp_torch.solvers.solver_types import PATHMCPParams

from test_torch_mcp import CORES, compare_carries, compare_results, jax_trace, port_trace
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

N, GAMES, ITERS = 5, 4, 40
ORACLE = dict(N=N, dt=0.1, tol=1e-3, max_iters=ITERS, max_restarts=4)


def chicane_pair():
    """The chicane in both packages on the same track tables."""
    jsc, sc = jax_chicane(N=N, theta_deg=45.0), build_chicane_scenario(N=N, theta_deg=45.0)
    interop.load_track_tables(sc.track, np.asarray(jsc.track._kp),
                              np.asarray(jsc.track._cum_angle))
    return jsc, sc


def chicane_batch(jsc, jsolver, games=GAMES, seed=0):
    """The JAX package's sampled games and warm starts (u0, l0, x0, up) as numpy."""
    x0, u_ws, _, _ = jax_sample(jsc, games, seed)
    u_ws = jnp.asarray(u_ws)
    u0 = jax.vmap(jsolver.problem.stage_to_u)(u_ws)
    up = jax_seed_up(jnp.zeros((games, jsc.joint_model.n_u)), u_ws[:, 0, :],
                     jsc.joint_model)
    l0 = jax.vmap(lambda u, x, p: jsolver.problem.dual_warm_start(u, x, p))(
        u0, jnp.asarray(x0), up)
    return tuple(np.asarray(a) for a in (u0, l0, x0, up))


def _solvers(jsc, sc, method):
    js = JaxPATHMCP(jsc.joint_model, jsc.costs, jsc.agent_constraints,
                    jsc.shared_constraints, jsc.bounds, JaxParams(method=method, **ORACLE),
                    print_method=None)
    ts = PATHMCP(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
                 sc.bounds, PATHMCPParams(method=method, **ORACLE), print_method=None,
                 dtype=torch.float64, device='cpu')
    return js, ts


@pytest.fixture(scope='module', params=['fbnewton', 'josephy'])
def traced(request):
    method = request.param
    jsc, sc = chicane_pair()
    js, ts = _solvers(jsc, sc, method)
    args = chicane_batch(jsc, js)
    core = getattr(js, CORES[method][0])
    res_j, hist_j = jax_trace(lambda u, l, x, p: core(u, l, x, p, None), ITERS,
                              *(jnp.asarray(a) for a in args))
    return method, ts, [torch.as_tensor(np.array(a)) for a in args], res_j, hist_j


def test_chicane_carries_match_jax(traced):
    method, ts, args, _, hist_j = traced
    compare_carries(port_trace(ts, method, 5, *args), hist_j)


def test_chicane_solves_match_jax(traced):
    method, ts, args, res_j, _ = traced
    res_t = ts.solve_batch(*args)
    assert not (res_t.status == RUNNING).any()
    compare_results(res_t, res_j)
