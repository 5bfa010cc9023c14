"""Port parity: condensed game derivatives (``dgsqp_torch.solvers.game_problem``).

On the chicane duel (N=5), the same inputs (numpy, fixed seed) go through the JAX
package's ``GameProblem`` vmapped over games and the port's batched ``GameProblem`` in
float64 on the CPU: ``evaluate`` (Q, q, G, g), ``merit_terms``, ``eval_q`` and
``dual_warm_start`` agree within 1e-10, and the static QP structures are identical.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.harness.scenarios import build_chicane_scenario as jax_chicane
from dgsqp_tpu.solvers.game_problem import GameProblem as JaxGameProblem
from dgsqp_torch.harness.scenarios import build_chicane_scenario as torch_chicane
from dgsqp_torch.solvers.game_problem import GameProblem

N, B = 5, 4
TOL = 1e-10


@pytest.fixture(scope='module')
def problems():
    jsc, tsc = jax_chicane(N=N), torch_chicane(N=N)
    jp = JaxGameProblem(jsc.joint_model, jsc.costs, jsc.agent_constraints,
                        jsc.shared_constraints, jsc.bounds, N)
    tp = GameProblem(tsc.joint_model, tsc.costs, tsc.agent_constraints,
                     tsc.shared_constraints, tsc.bounds, N, dtype=torch.float64,
                     device='cpu')
    return jp, tp


@pytest.fixture(scope='module')
def point(problems):
    """A batch of iterates: both cars on the first straight, moving, with inputs and
    duals drawn from a fixed seed (some duals zero, as at a real iterate)."""
    jp, tp = problems
    rng = np.random.default_rng(4)
    x0 = np.zeros((B, 12))
    for off, ey in ((0, -0.3), (6, 0.3)):
        x0[:, off + 2] = rng.uniform(2.0, 3.0, B)
        x0[:, off + 4] = rng.uniform(0.1, 0.9, B)
        x0[:, off + 5] = ey + rng.uniform(-0.1, 0.1, B)
    track = torch_chicane(N=N).track
    for off in (0, 6):
        xyp = track.local_to_global(torch.tensor(np.stack(
            [x0[:, off + 4], x0[:, off + 5], np.zeros(B)], -1))).numpy()
        x0[:, off:off + 2] = xyp[:, :2]
    u = rng.uniform(-0.3, 0.3, (B, tp.n_dec))
    l = np.maximum(rng.uniform(-1.0, 2.0, (B, tp.n_c_total)), 0.0)
    up = rng.uniform(-0.2, 0.2, (B, 4))
    return u, l, x0, up


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


def test_structure_matches(problems):
    jp, tp = problems
    assert tp.n_c_total == jp.n_c_total and tp.n_dec == jp.n_dec
    assert tp.input_box_structure() == jp.input_box_structure()
    assert tp.state_pair_structure() == jp.state_pair_structure()
    assert tp._stage_off.tolist() == jp._stage_off.tolist()


def test_evaluate_matches(problems, point):
    jp, tp = problems
    u, l, x0, up = point
    out_j = jax.vmap(jp.evaluate)(*_j(u, l, x0, up))
    out_t = tp.evaluate(*_t(u, l, x0, up))
    for name, a_j, a_t in zip(('Q', 'q', 'G', 'g', 'x'), out_j, out_t):
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=TOL,
                                   err_msg=name)
    # the first-derivative-only path gives the same (q, G, g, x)
    lite = tp.evaluate(*_t(u), None, *_t(x0, up), hessian=False)
    for a, b in zip(lite, out_t[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL)


def test_merit_terms_and_gradients_match(problems, point):
    jp, tp = problems
    u, l, x0, up = point
    d_j, g_j = jax.vmap(jp.merit_terms)(*_j(u, l, x0, up))
    d_t, g_t = tp.merit_terms(*_t(u, l, x0, up))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0, atol=TOL)
    q_j = jax.vmap(jp.eval_q)(*_j(u, x0, up))
    np.testing.assert_allclose(tp.eval_q(*_t(u, x0, up)).numpy(), np.asarray(q_j),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tp.stationarity(*_t(u, l, x0, up)).numpy(), d_t.numpy(),
                               rtol=0, atol=0)


def test_dual_warm_start_matches(problems, point):
    jp, tp = problems
    u, _, x0, up = point
    l_j = jax.vmap(jp.dual_warm_start)(*_j(u, x0, up))
    l_t = tp.dual_warm_start(*_t(u, x0, up))
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=0, atol=TOL)
