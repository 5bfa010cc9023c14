"""Port parity: the MCP oracle (``PATHMCP``) on the CPU in float64.

On the integrator game of ``tests/test_mcp.py`` (four games from a numpy seed):

* the FB-Newton and the Josephy-Newton cores: every field of the carry after each of
  the first 5 iterations agrees with the JAX core's (integer fields equal, the others
  within 1e-9 of each field's scale), then the whole solves agree: status and
  iterations equal, ``u``/``l``/``res`` within 1e-8;
* ``method='hybrid'``: the port's batched solve against the JAX package's composition
  of its two phases (``_solve_batch_hybrid``);
* a game capped at one iteration ends ``max_it`` (the study's warm-up);
* the host interface (``set_warm_start``/``solve``) solves and certifies the KKT
  conditions as ``tests/test_mcp.py`` does.

The JAX carries come from :func:`jax_trace`, which runs the JAX core with its outer
``lax.while_loop`` replaced by a fixed-length ``lax.scan`` that records the carry (the
body leaves a game's carry unchanged once its status left RUNNING, so the last carry is
the whole solve's).  The chicane at N=5 is in ``test_torch_mcp_chicane.py``, the
approximate game in ``test_torch_mcp_approx.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.solvers.mcp import PATHMCP as JaxPATHMCP
from dgsqp_tpu.solvers.solver_types import PATHMCPParams as JaxParams
from dgsqp_torch.solvers.mcp import MAX_IT, RUNNING, SOLVED, MCPResult, PATHMCP
from dgsqp_torch.solvers.solver_types import PATHMCPParams
from dgsqp_torch.types import VehicleState

from test_torch_v2_games import DT, N, jax_game, torch_game
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

STEPS = 5
GAMES = 4
CORES = {'fbnewton': ('_solve_core', '_fb_init', '_fb_body'),
         'josephy': ('_solve_core_josephy', '_jos_init', '_jos_body')}


def jax_trace(core, T, *args):
    """A JAX solve core (one game) vmapped over the games, with its outer
    ``lax.while_loop`` run as ``T`` recorded steps: returns (result, carries (B, T, ...)).
    Nested loops (the QP's) keep the real ``while_loop``."""
    real = jax.lax.while_loop

    def run(*a):
        box = {}

        def traced(cond, body, init):
            if box:
                return real(cond, body, init)

            def step(c, _):
                c2 = body(c)
                return c2, c2
            box['taken'] = True
            c, hist = jax.lax.scan(step, init, None, length=T)
            box['hist'] = hist
            return c
        jax.lax.while_loop = traced
        try:
            res = core(*a)
        finally:
            jax.lax.while_loop = real
        return res, box['hist']
    return jax.jit(jax.vmap(run))(*args)


def port_trace(solver, method, T, u0, l0, x0, up, P=None):
    """The port's carries after each of the first T iterations: a list of carries."""
    _, init, body = CORES[method]
    c = getattr(solver, init)(u0, l0)
    out = []
    for _ in range(T):
        c = getattr(solver, body)(c, x0, up, P)
        out.append(c)
    return out


def compare_carries(carries_t, hist_j, steps=STEPS, tol=1e-9):
    for k in range(steps):
        c = carries_t[k]
        for f in c._fields:
            a = np.asarray(getattr(hist_j, f))[:, k]
            b = getattr(c, f).numpy()
            msg = f'iteration {k + 1}, field {f}'
            if a.dtype.kind in 'biu':
                np.testing.assert_array_equal(b, a, err_msg=msg)
            else:
                fin = np.isfinite(a)
                np.testing.assert_array_equal(np.isfinite(b), fin, err_msg=msg)
                np.testing.assert_array_equal(b[~fin], a[~fin], err_msg=msg)
                scale = max(1.0, float(np.abs(a[fin]).max())) if fin.any() else 1.0
                np.testing.assert_allclose(b[fin], a[fin], rtol=0, atol=tol * scale,
                                           err_msg=msg)


def compare_results(res_t, res_j, tol=1e-8):
    for f in ('status', 'iters'):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(), np.asarray(getattr(res_j, f)),
                                      err_msg=f)
    for f in ('u', 'l', 'res', 'p_feas', 'comp', 'stat'):
        a = np.asarray(getattr(res_j, f))
        np.testing.assert_allclose(getattr(res_t, f).numpy(), a, rtol=0,
                                   atol=tol * max(1.0, float(np.abs(a).max())), err_msg=f)


def _params(cls, method, **kw):
    base = dict(N=N, dt=DT, tol=1e-9, method=method)
    if method == 'josephy':
        base.update(tol=1e-7, line_search_iters=8, max_iters=60)
    base.update(kw)
    return cls(**base)


def solvers(method, **kw):
    joint, costs, shared, bounds = jax_game()
    js = JaxPATHMCP(joint, costs, [None, None], shared, bounds, _params(JaxParams, method, **kw),
                    print_method=None)
    joint, costs, shared, bounds = torch_game()
    ts = PATHMCP(joint, costs, [None, None], shared, bounds,
                 _params(PATHMCPParams, method, **kw), print_method=None,
                 dtype=torch.float64, device='cpu')
    return js, ts


def batch(solver, games=GAMES, seed=0):
    """Warm starts away from the equilibrium (u, and duals l >= 0, some zero)."""
    rng = np.random.default_rng(seed)
    u0 = 0.5 * rng.normal(size=(games, solver.n_dec))
    l0 = np.maximum(rng.normal(size=(games, solver.n_c)), 0.0)
    x0 = 0.2 * rng.normal(size=(games, 2))
    return u0, l0, x0, np.zeros((games, solver.n_u))


@pytest.fixture(scope='module', params=['fbnewton', 'josephy'])
def traced(request):
    method = request.param
    js, ts = solvers(method)
    args = batch(js)
    core = getattr(js, CORES[method][0])
    res_j, hist_j = jax_trace(lambda u, l, x, p: core(u, l, x, p, None),
                              js.params.max_iters if method == 'josephy' else 30,
                              *(jnp.asarray(a) for a in args))
    args_t = [torch.as_tensor(a) for a in args]
    return method, js, ts, args_t, res_j, hist_j


def test_carries_match_jax_for_the_first_iterations(traced):
    method, js, ts, args, _, hist_j = traced
    compare_carries(port_trace(ts, method, STEPS, *args), hist_j)


def test_solves_match_jax(traced):
    method, js, ts, args, res_j, _ = traced
    res_t = ts.solve_batch(*args)
    assert isinstance(res_t, MCPResult)
    assert not (res_t.status == RUNNING).any()
    assert (res_t.status == SOLVED).all(), res_t.status
    compare_results(res_t, res_j)


def test_hybrid_matches_the_composed_jax_phases():
    js, ts = solvers('hybrid', max_iters=40, line_search_iters=8)
    args = batch(js, seed=1)
    res_j = js._solve_batch_hybrid(*(jnp.asarray(a) for a in args))
    res_t = ts.solve_batch(*(torch.as_tensor(a) for a in args))
    compare_results(res_t, res_j)
    assert (res_t.status == SOLVED).all()


def test_iteration_cap_ends_max_it():
    _, ts = solvers('fbnewton')
    args = [torch.as_tensor(a) for a in batch(ts)]
    res = ts.solve_batch(*args, max_iters=1)
    assert (res.iters == 1).all() and (res.status == MAX_IT).all()
    assert torch.isfinite(res.u).all() and torch.isfinite(res.l).all()


@pytest.mark.parametrize('method', ['fbnewton', 'josephy'])
def test_host_interface_certifies_kkt(method):
    _, ts = solvers(method)
    ts.set_warm_start(np.zeros((N, 2)))
    info = ts.solve([VehicleState(), VehicleState()])
    assert info['msg'] == 'MCP_Solved', info
    tol = 1e-7 if method == 'fbnewton' else 1e-6
    for k in ('p_feas', 'comp', 'stat'):
        assert info['cond'][k] < tol, (k, info['cond'])
    assert (info['l_sol'] >= -1e-9).all()
    assert ts.u_pred.shape == (N, 2) and ts.q_pred.shape == (N + 1, 2)
