"""Port parity: the rank mesh (``dgsqp_torch/parallel/mesh.py``) and the chunk driver's
compaction across ranks, on the CPU in float64, each rank a process on ``gloo``.

* ``pad_to_multiple``, ``shard_batch`` and ``convergence_stats`` give what the JAX
  functions give on the same arrays (a rank's block is the JAX shard of its device), and
  ``convergence_stats`` over ranks gives the counts of one process.
* The staggered-finisher chunk driver of ``tests/test_dgsqp.py`` over 2 and 4 ranks:
  every payload and status, and a bucket history equal to the JAX
  ``run_chunked_compacted`` on a mesh of as many devices (every bucket a multiple of
  the ranks).
* The heterogeneous integrator game of ``tests/test_dgsqp.py`` over 2 ranks (DGSQP v1's
  flat machine, compaction on): statuses equal to the JAX SPMD run and to the port's
  one-process run, ``u`` within 1e-10 of both, the buckets of both.
* ``__graft_entry__.py``'s three dry-run paths on its N=4 chicane over 2 ranks (the
  nested whole solve through ``sharded_batch_solve``, v1's flat chunked solve, v2's
  chunked solve): statuses equal to one process.
* The launcher: more ranks than CUDA devices without named devices raises, and a rank
  that raises fails the run.

Each rank runs a module-level function of this file (a spawned process imports it by
name; the JAX package is imported only inside the tests), on one torch thread and
within ``TIMEOUT_S``.
"""
from collections import namedtuple

import numpy as np
import pytest
import torch

from dgsqp_torch.parallel import mesh as pmesh
from dgsqp_torch.parallel.mesh import (GamesMesh, convergence_stats, pad_to_multiple,
                                       shard_batch, sharded_batch_solve, spawn_ranks)
from dgsqp_torch.solvers.chunked import run_chunked_compacted

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

TIMEOUT_S = 240.0
N, DT = 5, 0.1
Ticks = namedtuple('Ticks', ['status', 'ticks', 'payload'])


def _cpu_mesh(k, r):
    """Rank r of k without a process group: enough for the batch helpers."""
    return GamesMesh(k, r, torch.device('cpu'), ('h/cpu',) * k, 'gloo')


def _jax_mesh(k):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:k]), axis_names=('games',))
    return mesh, NamedSharding(mesh, P('games'))


# ----------------------------------------------------------------- batch helpers
def test_pad_and_shard_match_jax():
    from dgsqp_tpu.parallel import mesh as jmesh
    rng = np.random.default_rng(0)
    for b, k in ((7, 2), (8, 4), (5, 4), (6, 3)):
        arr = rng.normal(size=(b, 3))
        padded_j, n_j = jmesh.pad_to_multiple(arr, k)
        padded_t, n_t = pad_to_multiple(arr, k)
        assert n_t == n_j == b
        np.testing.assert_array_equal(padded_t, padded_j)
        tens, n_tt = pad_to_multiple(torch.as_tensor(arr), k)
        assert n_tt == b
        np.testing.assert_array_equal(tens.numpy(), padded_j)
        jm, _ = _jax_mesh(k)
        sharded = jmesh.shard_batch(jm, padded_j)
        shards = {s.device: np.asarray(s.data) for s in sharded.addressable_shards}
        for r, dev in enumerate(jm.devices):
            np.testing.assert_array_equal(shard_batch(_cpu_mesh(k, r), padded_t).numpy(),
                                          shards[dev])


def test_convergence_stats_match_jax():
    import jax.numpy as jnp
    from dgsqp_tpu.parallel import mesh as jmesh
    for statuses in (np.array([1, 2, 5, 1, 3, 1, 6]), np.array([5, 5, 5]),
                     np.random.default_rng(1).integers(0, 7, 37)):
        assert convergence_stats(statuses) == jmesh.convergence_stats(jnp.asarray(statuses))


def test_rows_pack_and_unpack():
    C = namedtuple('C', ['a', 'b', 'c', 'd'])
    tree = (C(torch.arange(12.0).reshape(3, 4), torch.tensor([True, False, True]),
              torch.arange(3, dtype=torch.int32), torch.zeros(3, 0)),
            torch.randn(3, 2, 2, dtype=torch.float64))
    packed, layout = pmesh.pack_rows(tree, 3)
    assert packed.dtype == torch.uint8 and packed.shape[0] == 3
    back = pmesh.unpack_rows(packed[[2, 0]], layout, tree)
    assert type(back[0]) is C
    for x, y in zip(pmesh._leaves(back), pmesh._leaves(tree)):
        assert x.dtype == y.dtype and torch.equal(x, y[[2, 0]])


# ----------------------------------------------------------------- chunk driver
def _tick_chunk(c, x, u_p):
    running = c.status == 0     # finished games freeze, as the solvers' bodies do
    ticks = torch.where(running, c.ticks - 1, c.ticks)
    payload = torch.where(running[:, None], c.payload + x[:, :1], c.payload)
    return Ticks((ticks <= 0).to(torch.int32), ticks, payload)


def _ticks_batch(k):
    """tests/test_dgsqp.py's staggered finishers: game i ends after ticks0[i] chunks."""
    B = 4 * k
    ticks0 = np.array([1 + 3 * (i % 3) + (7 if i % 11 == 0 else 0) for i in range(B)])
    x0 = np.arange(B, dtype=np.float64)[:, None] * np.ones((1, 3))
    return ticks0, x0, np.zeros((B, 2))


def _rank_ticks(mesh, ticks0, x0, up):
    lo, hi = mesh.block(ticks0.size)
    carry = Ticks(torch.zeros(hi - lo, dtype=torch.int32), torch.as_tensor(ticks0[lo:hi]),
                  torch.zeros(hi - lo, 1, dtype=torch.float64))
    final, history = run_chunked_compacted(
        carry, torch.as_tensor(x0[lo:hi]), torch.as_tensor(up[lo:hi]), _tick_chunk,
        final_fn=lambda c, x, u_p: c, running_status=0, max_chunks=50, min_bucket=2,
        mesh=mesh)
    return (final.payload[:, 0].numpy(), final.status.numpy(),
            [h['batch'] for h in history], [h['running'] for h in history])


def _jax_ticks(k, ticks0, x0, up):
    import jax
    import jax.numpy as jnp
    from dgsqp_tpu.solvers.chunked import run_chunked_compacted as jax_driver

    def chunk_fn(c, x, u_p):
        running = c.status == 0
        ticks = jnp.where(running, c.ticks - 1, c.ticks)
        payload = jnp.where(running[:, None], c.payload + x[:, :1], c.payload)
        return Ticks(jnp.where(ticks <= 0, 1, 0).astype(jnp.int32), ticks, payload)

    _, sharding = _jax_mesh(k)
    B = ticks0.size
    carry = jax.device_put(Ticks(jnp.zeros(B, jnp.int32), jnp.asarray(ticks0),
                                 jnp.zeros((B, 1))), sharding)
    _, history = jax_driver(carry, jax.device_put(jnp.asarray(x0), sharding),
                            jax.device_put(jnp.asarray(up), sharding), chunk_fn,
                            final_fn=lambda c, x, u_p: c, running_status=0, max_chunks=50,
                            min_bucket=2)
    return [h['batch'] for h in history], [h['running'] for h in history]


@pytest.mark.parametrize('k', [2, 4])
def test_chunk_driver_compacts_across_ranks(k):
    ticks0, x0, up = _ticks_batch(k)
    out = spawn_ranks(_rank_ticks, k, ticks0, x0, up, devices='cpu', timeout_s=TIMEOUT_S)
    batches_j, running_j = _jax_ticks(k, ticks0, x0, up)
    for payload, status, batches, running in out:
        # every game ran exactly ticks0 chunks and came back to its own slot
        np.testing.assert_array_equal(payload, ticks0 * x0[:, 0])
        assert (status == 1).all()
        assert batches == batches_j and running == running_j
        assert min(batches) < 4 * k and all(b % k == 0 for b in batches)


# ----------------------------------------------------------------- integrator game
def _integrator_solver(pkg):
    """tests/test_dgsqp.py's heterogeneous integrator game (``tanh`` rivalry, input
    bound 5) with the study parameters; the compaction bucket's floor is 2."""
    if pkg == 'jax':
        import jax.numpy as xp
        from dgsqp_tpu.dynamics import (DynamicsConfig, IntegratorModel,
                                        MultiAgentDynamicsModel)
        from dgsqp_tpu.solvers.dgsqp import DGSQP
        from dgsqp_tpu.solvers.solver_types import DGSQPParams
        from dgsqp_tpu.types import VehicleState
        X, kw = (lambda x, i: x[i]), {}
    else:
        xp = torch
        from dgsqp_torch.dynamics import (DynamicsConfig, IntegratorModel,
                                          MultiAgentDynamicsModel)
        from dgsqp_torch.solvers.dgsqp import DGSQP
        from dgsqp_torch.solvers.solver_types import DGSQPParams
        from dgsqp_torch.types import VehicleState
        X, kw = (lambda x, i: x[..., i]), dict(dtype=torch.float64, device='cpu')
    joint = MultiAgentDynamicsModel(0.0, [IntegratorModel(0.0, DynamicsConfig(dt=DT)),
                                          IntegratorModel(0.0, DynamicsConfig(dt=DT))])

    def stage(x, u, um):
        return 0.5 * X(u, 0) ** 2

    def term(a):
        return lambda x: (0.5 * 100.0 * (X(x, a) - 1.0) ** 2
                          + 0.5 * xp.tanh(X(x, a) - X(x, 1 - a)))
    ub, lb = VehicleState(), VehicleState()
    ub.v.v_long, ub.u.u_a = np.inf, 5.0
    lb.v.v_long, lb.u.u_a = -np.inf, -5.0
    params = DGSQPParams(N=N, dt=DT, reg=1e-3, p_tol=1e-8, d_tol=1e-8, sqp_iters=50,
                         nonmono_ls=True, beta=0.01, tau=0.5)
    solver = DGSQP(joint, [(stage, term(0)), (stage, term(1))], [None, None], None,
                   {'ub': [ub, ub], 'lb': [lb, lb]}, params, print_method=None, **kw)
    solver._compact_min_bucket = 2
    return solver


def _integrator_batch(k=2):
    """Most games start near the target and end in the first chunk; four start in
    [-3, 3]^2 and need a second, forcing a compaction (the JAX test's stragglers from
    [-30, -20]^2 end in the first chunk too, against the input bound)."""
    rng = np.random.default_rng(11)
    B = 4 * k * 2
    x0 = np.concatenate([rng.uniform(0.9, 1.1, (B - 4, 2)),
                         np.random.default_rng(3).uniform(-3.0, 3.0, (4, 2))])
    solver = _integrator_solver('torch')
    return (np.zeros((B, 2 * N)), np.zeros((B, solver.n_c)), x0, np.zeros((B, 2)))


def _rank_integrator(mesh, args):
    solver = _integrator_solver('torch')
    blocks = [shard_batch(mesh, a) for a in args]
    res = solver.solve_batch_chunked(*blocks, chunk_iters=1, mesh=mesh)
    return (res.status.numpy(), res.u.numpy(), res.iters.numpy(),
            [h['batch'] for h in solver.last_chunk_history])


def test_integrator_game_over_two_ranks_matches_jax_and_one_process():
    import jax
    import jax.numpy as jnp
    args = _integrator_batch()
    out = spawn_ranks(_rank_integrator, 2, args, devices='cpu', timeout_s=TIMEOUT_S)
    one = _integrator_solver('torch')
    res_1 = one.solve_batch_chunked(*[torch.as_tensor(a) for a in args], chunk_iters=1)
    hist_1 = [h['batch'] for h in one.last_chunk_history]
    js = _integrator_solver('jax')
    _, sharding = _jax_mesh(2)
    res_j = js.solve_batch_chunked(*[jax.device_put(jnp.asarray(a), sharding)
                                     for a in args], chunk_iters=1)
    hist_j = [h['batch'] for h in js.last_chunk_history]
    assert min(hist_j) < len(args[0])           # the JAX run compacted
    for status, u, iters, hist in out:
        np.testing.assert_array_equal(status, np.asarray(res_j.status))
        np.testing.assert_array_equal(status, res_1.status.numpy())
        np.testing.assert_array_equal(iters, res_1.iters.numpy())
        np.testing.assert_allclose(u, np.asarray(res_j.u), rtol=0, atol=1e-10)
        np.testing.assert_allclose(u, res_1.u.numpy(), rtol=0, atol=1e-10)
        assert hist == hist_j == hist_1


# ----------------------------------------------------------------- dry-run paths
def _graft_batch(k=2):
    B = 2 * k
    x0_one = np.array([0.5, 0.0, 2.0, 0.0, 0.5, 0.0, 1.5, 0.3, 2.2, 0.0, 1.5, 0.3])
    return np.tile(x0_one, (B, 1)) + 0.01 * np.arange(B)[:, None]


def _graft_paths(mesh, x0_h):
    """The three paths of ``__graft_entry__.dryrun_multichip`` on the N=4 chicane: a
    status array each (the whole batch), run over ``mesh`` (or one process)."""
    from dgsqp_torch.harness.scenarios import build_chicane_scenario
    from dgsqp_torch.solvers.dgsqp import DGSQP
    from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
    from dgsqp_torch.solvers.solver_types import DGSQPParams, DGSQPV2Params
    sc = build_chicane_scenario(N=4, theta_deg=45.0)
    kw = dict(print_method=None, dtype=torch.float64, device='cpu')
    game = (sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
            sc.bounds)
    nested = DGSQP(*game, DGSQPParams(N=sc.N, dt=sc.dt, reg=1e-3, nonmono_ls=False,
                                      line_search_iters=10, sqp_iters=3, p_tol=1e-3,
                                      d_tol=1e-3, beta=0.01, tau=0.5), **kw)
    flat = DGSQP(*game, DGSQPParams(N=sc.N, dt=sc.dt, reg=1e-3, nonmono_ls=True,
                                    line_search_iters=10, sqp_iters=25, p_tol=1e-3,
                                    d_tol=1e-3), **kw)
    v2 = DGSQPV2(*game, DGSQPV2Params(N=sc.N, dt=sc.dt, reg=1e1, reg_decay=0.95, nms=True,
                                      sqp_iters=30, p_tol=1e-3, d_tol=1e-3), **kw)
    assert not nested._use_flat() and flat._use_flat()
    B = x0_h.shape[0]
    args = [torch.zeros(B, flat.n_dec, dtype=torch.float64),
            torch.zeros(B, flat.n_c, dtype=torch.float64),
            torch.as_tensor(x0_h), torch.zeros(B, flat.n_u, dtype=torch.float64)]
    if mesh is None:
        res = [nested._solve_core(*args), flat.solve_batch_chunked(*args, chunk_iters=2),
               v2.solve_batch_chunked(*args, chunk_iters=4)]
    else:
        blocks = [shard_batch(mesh, a) for a in args]
        res = [sharded_batch_solve(nested._solve_core, mesh, *args),
               flat.solve_batch_chunked(*blocks, chunk_iters=2, mesh=mesh),
               v2.solve_batch_chunked(*blocks, chunk_iters=4, mesh=mesh)]
    return [r.status.numpy() for r in res]


def test_dryrun_paths_over_two_ranks_match_one_process():
    x0_h = _graft_batch()
    one = _graft_paths(None, x0_h)
    for statuses in spawn_ranks(_graft_paths, 2, x0_h, devices='cpu', timeout_s=TIMEOUT_S):
        for st, st_1 in zip(statuses, one):
            np.testing.assert_array_equal(st, st_1)
    # the v2 toy games converge (the JAX dry run's budget is sized for it)
    assert np.isin(one[2], (1, 2)).all(), one[2]


# ----------------------------------------------------------------- the launcher
def _rank_fails(mesh):
    if mesh.rank == 1:
        raise ValueError('rank one fails')
    # rank 0 waits in a collective that rank 1 never joins
    mesh.all_reduce_sum(torch.ones(1))
    return mesh.rank


def test_a_failed_rank_fails_the_run():
    with pytest.raises(RuntimeError, match='rank 1'):
        spawn_ranks(_rank_fails, 2, devices='cpu', timeout_s=TIMEOUT_S)


def _rank_describe(mesh):
    stats = convergence_stats(np.array([1, 5, 2, 1])[2 * mesh.rank:2 * mesh.rank + 2],
                              mesh)
    return mesh.size, mesh.rank, mesh.backend, mesh.devices, str(mesh.device), stats


def test_ranks_describe_their_mesh():
    out = spawn_ranks(_rank_describe, 2, devices=['cpu', 'cpu'], timeout_s=TIMEOUT_S)
    for r, (size, rank, backend, devices, device, stats) in enumerate(out):
        assert (size, rank, backend, device) == (2, r, 'gloo', 'cpu')
        assert len(devices) == 2 and all(d.endswith('/cpu') for d in devices)
        assert stats == convergence_stats(np.array([1, 5, 2, 1]))


def test_devices_are_never_guessed():
    with pytest.raises((RuntimeError, ValueError), match='CUDA device'):
        pmesh.resolve_devices(None, torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match='3 device'):
        pmesh.resolve_devices(['cpu', 'cpu', 'cpu'], 2)
    with pytest.raises(ValueError, match='index'):
        pmesh.resolve_devices(['cuda', 'cpu'], 2)
    assert pmesh.resolve_devices('cuda:0,cuda:0', 2) == [torch.device('cuda', 0)] * 2
    assert pmesh.resolve_devices('cpu', 3) == [torch.device('cpu')] * 3
    mesh = pmesh.games_mesh(1, devices='cpu')
    assert (mesh.size, mesh.rank, mesh.device) == (1, 0, torch.device('cpu'))
