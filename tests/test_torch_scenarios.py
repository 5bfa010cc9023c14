"""Port parity: the curve and agents scenarios and the agents sampler.

On the CPU in float64, with the JAX package's track tables installed in the port's
track (``dgsqp_torch.interop``):

* ``sample_agents_initial_conditions`` returns the same arrays as the JAX package's
  (1e-12, absolute);
* the curve duel (N = 6) and the agents game (M = 2 and 3, N = 6) evaluate to the same
  ``Q, q, G, g`` as the JAX package's at the sampler's first game, with the JAX
  package's dual warm start (1e-10, absolute), and ``agent_cost`` and
  ``constraint_indices_for_agent`` agree (1e-10; equal).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.harness import samplers as jax_samplers
from dgsqp_tpu.harness import scenarios as jax_scenarios
from dgsqp_tpu.solvers.game_problem import GameProblem as JaxGameProblem
from dgsqp_torch import interop
from dgsqp_torch.harness import samplers, scenarios
from dgsqp_torch.solvers.game_problem import GameProblem

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

N = 6
FACTORIES = {
    'curve': (lambda m: m.build_curve_scenario(N=N), 'sample_duel_initial_conditions'),
    'agents_M2': (lambda m: m.build_agents_scenario(M=2, N=N),
                  'sample_agents_initial_conditions'),
    'agents_M3': (lambda m: m.build_agents_scenario(M=3, N=N),
                  'sample_agents_initial_conditions'),
}


def _problem(cls, sc, **kw):
    return cls(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
               sc.bounds, sc.N, **kw)


@pytest.fixture(scope='module', params=list(FACTORIES))
def pair(request):
    build, sampler = FACTORIES[request.param]
    jsc, sc = build(jax_scenarios), build(scenarios)
    assert sc.name == jsc.name
    # both packages query bit-identical track tables
    interop.load_track_tables(sc.track, np.asarray(jsc.track._kp),
                              np.asarray(jsc.track._cum_angle))
    sample_j = getattr(jax_samplers, sampler)(jsc, 4, seed=0)
    sample_t = getattr(samplers, sampler)(sc, 4, seed=0, dtype=torch.float64, device='cpu')
    return jsc, sc, sample_j, sample_t


def test_sampler_returns_the_same_games(pair):
    _, sc, sample_j, sample_t = pair
    assert len(sample_t) == 4
    for a_j, a_t in zip(sample_j, sample_t):
        assert a_t.shape == np.asarray(a_j).shape and a_t.shape[0] == 4
        np.testing.assert_allclose(a_t, np.asarray(a_j), rtol=0, atol=1e-12)
    assert sample_t[1].shape == (4, N, sc.joint_model.n_u)


def test_first_game_evaluates_the_same(pair):
    jsc, sc, sample_j, _ = pair
    jprob = _problem(JaxGameProblem, jsc, dtype=jnp.float64)
    prob = _problem(GameProblem, sc, dtype=torch.float64, device='cpu')
    assert (prob.n_dec, prob.n_c_total) == (jprob.n_dec, jprob.n_c_total)
    x0, u_ws = np.asarray(sample_j[0][0]), np.asarray(sample_j[1][0])
    u = np.asarray(jprob.stage_to_u(jnp.asarray(u_ws)))
    up = np.zeros(jsc.joint_model.n_u)
    l = np.asarray(jax.jit(jprob.dual_warm_start)(jnp.asarray(u), jnp.asarray(x0),
                                                  jnp.asarray(up)))
    out_j = jax.jit(jprob.evaluate)(jnp.asarray(u), jnp.asarray(l), jnp.asarray(x0),
                                    jnp.asarray(up))
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)[None]
    np.testing.assert_allclose(prob.stage_to_u(t(u_ws))[0].numpy(), u, rtol=0, atol=0)
    out_t = prob.evaluate(t(u), t(l), t(x0), t(up))
    for name, a_t, a_j in zip('QqGg', out_t, out_j):
        np.testing.assert_allclose(a_t[0].numpy(), np.asarray(a_j), rtol=0, atol=1e-10,
                                   err_msg=name)
    np.testing.assert_allclose(prob.dual_warm_start(t(u), t(x0), t(up))[0].numpy(), l,
                                rtol=0, atol=1e-8)
    for a in range(prob.M):
        np.testing.assert_array_equal(prob.constraint_indices_for_agent(a),
                                      jprob.constraint_indices_for_agent(a))
        np.testing.assert_allclose(
            prob.agent_cost(a, t(u), t(x0), t(up))[0].numpy(),
            np.asarray(jax.jit(jprob.agent_cost, static_argnums=0)(
                a, jnp.asarray(u), jnp.asarray(x0), jnp.asarray(up))),
            rtol=0, atol=1e-10)
