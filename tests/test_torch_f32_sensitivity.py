"""Where the approximate dynamic duel's float32 gradient error comes from, on the CPU.

``DGSQPV2FrenetApprox``'s lag cost (weight ``q_l`` = 1000) is taken on the lag error, a
difference of two ~5 m positions read off a 150-sub-step rollout, so the rollout's
float32 rounding (~1e-6 relative) moves the game gradient q by a few 1e-3 of its
largest entry, and the ill-conditioned QP step by more.  The games are the study's
draw (``sample_dynamic_pa_initial_conditions``, seed 0) at the warm start, prepared as
``chip_smoke.py``'s ``dynamic_parity`` prepares them.

* With the lag weight cut to 1, float32 is within 1e-4 of float64 on Q and q, as on
  the other games; with it, the fused step's plain version and ``torch.func`` on the
  model's ``fd_plain`` agree in float32 within 1e-5 on Q and q: the error is the
  cost's, not the step derivatives' (N = 6, 4 games).
* ``slow``: on the 16 games and N = 15 of ``dynamic_parity``, the port's float32 is no
  farther from float64 on q than the JAX package's own float32 (and the two float64
  gradients agree within 1e-10).  It prints both differences.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from dgsqp_torch.harness.dynamic_study import sample_dynamic_pa_initial_conditions
from dgsqp_torch.harness.scenarios import build_dynamic_approximate_duel
from dgsqp_torch.solvers.dgsqp_v2_frenet import DGSQPV2FrenetApprox

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)


def _games(N, games):
    sc = build_dynamic_approximate_duel(N=N)
    return sc, cs.study_batch(sc, cs.dynamic_approx_solver(sc, torch.float32, 'cpu'), games,
                              sample_dynamic_pa_initial_conditions)


def _evaluate(sc, batch, dtype, q_l=1000.0):
    sol = DGSQPV2FrenetApprox(sc.joint_model, sc.costs, sc.agent_constraints,
                              sc.shared_constraints, sc.bounds,
                              cs.dynamic_approx_solver(sc, dtype, 'cpu').params,
                              print_method=None, q_l=q_l, dtype=dtype, device='cpu')
    Q, q = sol.problem.evaluate(*(a.detach().to(dtype) for a in batch))[:2]
    return Q.double(), q.double()


def test_f32_gradient_error_is_the_lag_cost():
    sc, batch = _games(6, 4)
    for a, b in zip(_evaluate(sc, batch, torch.float32, q_l=1.0),
                    _evaluate(sc, batch, torch.float64, q_l=1.0)):
        assert cs.rel_err(a, b) <= 1e-4
    fused = _evaluate(sc, batch, torch.float32)
    for m in sc.joint_model.dynamics_models:
        m.fd = m.fd_plain               # the step differentiated by torch.func instead
    for a, b in zip(_evaluate(sc, batch, torch.float32), fused):
        assert cs.rel_err(a, b) <= 1e-5


@pytest.mark.slow
def test_f32_gradient_error_no_worse_than_jax():
    import jax
    import jax.numpy as jnp
    from dgsqp_tpu.harness.scenarios import build_dynamic_approximate_duel as jax_build
    from dgsqp_tpu.solvers.dgsqp_v2_frenet import DGSQPV2FrenetApprox as JaxApprox
    from dgsqp_tpu.solvers.solver_types import DGSQPV2Params as JaxParams
    sc, batch = _games(cs.DYN_N, 16)
    js = jax_build(N=cs.DYN_N)
    q = {}
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        q['port', dtype] = _evaluate(sc, batch, dtype)[1].numpy()
        sol = JaxApprox(js.joint_model, js.costs, js.agent_constraints, js.shared_constraints,
                        js.bounds, JaxParams(N=cs.DYN_N, dt=js.dt, approximation_eval='exact'),
                        print_method=None, dtype=jdtype)
        args = [jnp.asarray(a.detach().double().numpy(), jdtype) for a in batch]
        q['jax', dtype] = np.asarray(jax.jit(jax.vmap(
            lambda u, l, x0, up: sol.problem.evaluate(u, l, x0, up)[1]))(*args), np.float64)
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    port = rel(q['port', torch.float32], q['port', torch.float64])
    ref = rel(q['jax', torch.float32], q['jax', torch.float64])
    print({'q_rel_diff_float32_vs_float64': {'port': port, 'jax': ref}})
    assert rel(q['port', torch.float64], q['jax', torch.float64]) <= 1e-10
    assert port <= ref
