"""Port parity: ``PATHMCPFrenetApprox``, the MCP oracle on the approximate (MPCC) duel
at N=5 (progress-augmented bicycles, n=30 decisions), on the CPU in float64.

The contouring/boundary parameters are re-linearized at every evaluation point (the
donor ``DGSQPV2FrenetApprox``'s ``_evaluate_mpcc``).  On the x0 of
``tests/test_frenet_approx.py`` and a shifted second game, from a zero input warm start
and the JAX package's dual warm start: the FB-Newton core (8 iterations) and the
Josephy-Newton core (4 iterations) give the same status and iterations as the JAX
package's, ``u``/``l`` within 1e-8 of each field's scale.  Both packages read
bit-identical geometry (``share_geometry`` of ``test_torch_approx_duel.py``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.harness.scenarios import build_approximate_duel as jax_duel
from dgsqp_tpu.solvers.mcp import PATHMCPFrenetApprox as JaxApproxMCP
from dgsqp_tpu.solvers.solver_types import PATHMCPParams as JaxParams
from dgsqp_torch.harness.scenarios import build_approximate_duel
from dgsqp_torch.solvers.mcp import PATHMCPFrenetApprox
from dgsqp_torch.solvers.solver_types import PATHMCPParams

from test_torch_approx_duel import X0, share_geometry
from test_torch_mcp import compare_results
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

N = 5


@pytest.mark.parametrize('method,iters', [('fbnewton', 8), ('josephy', 4)])
def test_frenet_approx_mcp_matches_jax(method, iters):
    jsc, sc = jax_duel(N=N), build_approximate_duel(N=N)
    share_geometry(jsc, sc)
    kw = dict(N=N, dt=jsc.dt, tol=1e-3, method=method, max_iters=iters)
    js = JaxApproxMCP(jsc.joint_model, jsc.costs, jsc.agent_constraints,
                      jsc.shared_constraints, jsc.bounds, JaxParams(**kw), print_method=None)
    ts = PATHMCPFrenetApprox(sc.joint_model, sc.costs, sc.agent_constraints,
                             sc.shared_constraints, sc.bounds, PATHMCPParams(**kw),
                             print_method=None, dtype=torch.float64, device='cpu')
    assert ts.n_dec == 30 and ts.n_c == js.n_c
    x0 = np.stack([X0, X0 + np.array([0.2, 0.1, 0.3, 0.05, 0.2, -0.1, 0.1, -0.2, 0.0, -0.1])])
    B = x0.shape[0]
    u0, up = np.zeros((B, ts.n_dec)), np.zeros((B, 6))
    l0 = np.asarray(jax.vmap(lambda u, x, p: js.problem.dual_warm_start(
        u, x, p, P=js._approx_update(u, x)))(jnp.asarray(u0), jnp.asarray(x0), jnp.asarray(up)))
    args = (u0, l0, x0, up)
    res_j = js._solve_batch_jit(*(jnp.asarray(a) for a in args), None)
    res_t = ts.solve_batch(*(torch.as_tensor(np.array(a)) for a in args))
    compare_results(res_t, res_j)
    assert torch.isfinite(res_t.u).all() and (res_t.iters > 0).all()
