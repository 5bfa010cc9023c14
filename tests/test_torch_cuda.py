"""The CUDA wrappers of ``dgsqp_torch.ops.linalg``: launch counting and input checks;
the port's tracer on the clock of ``torch.profiler``'s device trace; ``evaluate``'s CUDA
graphs (``dgsqp_torch.utils.cuda_graphs``): replays bit for bit the eager call, fresh
outputs, one graph a signature, eager inside an outer capture, launch counts kept, eager
for good where a capture raises.

The kernels are held against their plain versions, at every main-path shape, by the
``kernels`` phase of ``chip_smoke.py``; these tests cover what that phase does not.  They
need an NVIDIA GPU and ``nvcc`` (marker ``cuda``) and skip elsewhere.  The file imports
no JAX; on a machine with the port's requirements only, skip the JAX ``conftest.py`` and
the xdist options of ``pytest.ini``:

    python -m pytest --noconftest -o addopts= -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from dgsqp_torch.ops import linalg
from dgsqp_torch.utils import cuda_graphs, profiling

# the most a device event of a traced body may lie outside the body's host span
CLOCK_TOL_NS = 50_000


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_cuda_wrappers_count_launches_and_reject_bad_layout(dtype):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    A = (torch.eye(8, dtype=dtype, device='cuda') * 4.0).expand(3, 8, 8).contiguous()
    b = torch.ones(3, 8, dtype=dtype, device='cuda')
    n_chol, n_solve = linalg.cholesky.launches, linalg.cho_solve.launches
    by_n = (linalg.cholesky.launches_by_n.get(8, 0), linalg.cho_solve.launches_by_n.get(8, 0))
    L = linalg.cholesky(A)
    x = linalg.cho_solve(L, b)
    assert (linalg.cholesky.launches, linalg.cho_solve.launches) == (n_chol + 1, n_solve + 1)
    assert (linalg.cholesky.launches_by_n[8], linalg.cho_solve.launches_by_n[8]) \
        == (by_n[0] + 1, by_n[1] + 1)
    assert torch.equal(L, 2.0 * torch.eye(8, dtype=dtype, device='cuda').expand(3, 8, 8))
    assert torch.equal(x, torch.full_like(b, 0.25))
    with pytest.raises(ValueError):
        linalg.cholesky(A.transpose(-1, -2))                    # not contiguous
    with pytest.raises(ValueError):
        linalg.cho_solve(L, b.to(torch.float16))                # dtype differs from L
    assert (linalg.cholesky.launches, linalg.cho_solve.launches) == (n_chol + 1, n_solve + 1)


@pytest.mark.cuda
def test_cuda_kernel_rejects_oversized_matrix():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    A = torch.eye(200, dtype=torch.float64, device='cuda')[None]
    with pytest.raises(ValueError):
        linalg.cholesky(A)


@pytest.mark.cuda
def test_shared_memory_attribute_is_set_once_per_instantiation():
    """1000 launches of each kernel at one size raise its shared-memory limit at most
    once (once exactly when this is the size's first use in the process)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    A = (torch.eye(100, device='cuda') * 4.0).expand(4, 100, 100).contiguous()
    b1 = torch.ones(4, 100, device='cuda')
    b64 = torch.ones(4, 100, 64, device='cuda')
    L = linalg.cholesky(A)
    linalg.cho_solve(L, b1)
    linalg.cho_solve(L, b64)
    n_sets = (linalg.cholesky.attr_sets, linalg.cho_solve.attr_sets)
    n_launch = (linalg.cholesky.launches, linalg.cho_solve.launches)
    assert n_sets[0] >= 1 and n_sets[1] >= 2      # chol; warp and column kernels
    for _ in range(1000):
        linalg.cholesky(A)
        linalg.cho_solve(L, b1)
        x = linalg.cho_solve(L, b64)
    torch.cuda.synchronize()
    assert (linalg.cholesky.attr_sets, linalg.cho_solve.attr_sets) == n_sets
    assert (linalg.cholesky.launches, linalg.cho_solve.launches) \
        == (n_launch[0] + 1000, n_launch[1] + 2000)
    assert torch.equal(x, torch.full_like(b64, 0.25))
    # a smaller matrix needs no new limit; a larger one raises it once
    small = (torch.eye(24, device='cuda') * 4.0).expand(4, 24, 24).contiguous()
    big = (torch.eye(120, device='cuda') * 4.0).expand(4, 120, 120).contiguous()
    linalg.cholesky(small)
    assert linalg.cholesky.attr_sets == n_sets[0]
    linalg.cholesky(big)
    linalg.cholesky(big)
    assert linalg.cholesky.attr_sets == n_sets[0] + 1


@pytest.mark.cuda
def test_v2_round_on_the_card_launches_both_kernels_and_matches_cpu_float64():
    """One DGSQP v2 round on 4 games of the bench batch (N = 25): float32 on the card
    against float64 on the CPU, within the tolerances of ``chip_smoke.py``'s parity
    phase (derivative-based measures ``DERIV_RTOL``, the step ``STEP_RTOL``)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    from chip_smoke import DERIV_RTOL, STEP_RTOL, rel_err
    from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
    from dgsqp_torch.harness.scenarios import build_chicane_scenario
    sc = build_chicane_scenario(N=25, theta_deg=45.0)
    _, sol_d = build_bench_solver(horizon=25, solver_name='v2', scenario=sc,
                                  dtype=torch.float32, device='cuda')
    _, sol_c = build_bench_solver(horizon=25, solver_name='v2', scenario=sc,
                                  dtype=torch.float64, device='cpu')
    batch_d = build_bench_batch(sc, sol_d, 4, seed=0)
    batch_c = tuple(a.to('cpu', torch.float64) for a in batch_d)
    c_d0 = sol_d._init_carry(*batch_d)
    n_chol, n_solve = linalg.cholesky.launches, linalg.cho_solve.launches
    c_d = sol_d._make_body(batch_d[2], batch_d[3])(c_d0)
    assert linalg.cholesky.launches > n_chol and linalg.cho_solve.launches > n_solve
    c_c = sol_c._make_body(batch_c[2], batch_c[3])(sol_c._init_carry(*batch_c))
    for f in ('status', 'it', 'm_it', 'qp_solves', 'ck_counter', 'ck_valid', 'ck_fresh'):
        assert torch.equal(getattr(c_d, f).cpu(), getattr(c_c, f)), f
    assert int(c_d.it.min()) == 1 and not torch.equal(c_d.u, c_d0.u)
    for f, tol in (('memory', DERIV_RTOL), ('p_feas', DERIV_RTOL), ('comp', DERIV_RTOL),
                   ('stat', DERIV_RTOL), ('u', STEP_RTOL), ('delta', STEP_RTOL)):
        a, b = getattr(c_d, f).to('cpu', torch.float64), getattr(c_c, f)
        finite = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), finite), f
        assert rel_err(a[finite], b[finite]) <= tol, f


@pytest.mark.cuda
def test_approx_round_on_the_card_launches_both_kernels_and_matches_cpu_float64():
    """One round of ``DGSQPV2FrenetApprox`` (the ``approx`` bench solver, n = 150) on 4
    games: float32 on the card against float64 on the CPU, within the tolerances of
    ``chip_smoke.py``'s parity phases."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    from chip_smoke import DERIV_RTOL, STEP_RTOL, rel_err
    from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
    sc, sol_d = build_bench_solver(horizon=25, solver_name='approx', dtype=torch.float32,
                                   device='cuda')
    _, sol_c = build_bench_solver(horizon=25, solver_name='approx', scenario=sc,
                                  dtype=torch.float64, device='cpu')
    assert sol_d.n_dec == 150
    batch_d = build_bench_batch(sc, sol_d, 4, seed=0)
    batch_c = tuple(a.to('cpu', torch.float64) for a in batch_d)
    c_d0 = sol_d._init_carry(*batch_d)
    n_chol, n_solve = linalg.cholesky.launches, linalg.cho_solve.launches
    c_d = sol_d._make_body(batch_d[2], batch_d[3])(c_d0)
    assert linalg.cholesky.launches > n_chol and linalg.cho_solve.launches > n_solve
    c_c = sol_c._make_body(batch_c[2], batch_c[3])(sol_c._init_carry(*batch_c))
    for f in ('status', 'it', 'm_it', 'qp_solves', 'ck_counter', 'ck_valid', 'ck_fresh'):
        assert torch.equal(getattr(c_d, f).cpu(), getattr(c_c, f)), f
    assert int(c_d.it.min()) == 1 and not torch.equal(c_d.u, c_d0.u)
    for f, tol in (('memory', DERIV_RTOL), ('p_feas', DERIV_RTOL), ('stat', DERIV_RTOL),
                   ('u', STEP_RTOL)):
        a, b = getattr(c_d, f).to('cpu', torch.float64), getattr(c_c, f)
        finite = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), finite), f
        assert rel_err(a[finite], b[finite]) <= tol, f


@pytest.mark.cuda
def test_frenet_approx_mcp_on_the_card_matches_cpu_float64():
    """A few iterations of the MCP oracle on the approximate game
    (``PATHMCPFrenetApprox``, ``method='hybrid'``, two iterations a phase) on 4 games
    of the approximate duel (N = 10): float64 on the card against float64 on the CPU,
    the same statuses and iterations, ``u``/``l`` within 1e-6 of their scale."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    from chip_smoke import rel_err
    from dgsqp_torch.harness.mc_study import _dual_warm_start, _sample
    from dgsqp_torch.harness.scenarios import build_approximate_duel
    from dgsqp_torch.solvers.mcp import PATHMCPFrenetApprox
    from dgsqp_torch.solvers.solver_types import PATHMCPParams
    sc = build_approximate_duel(N=10)
    params = PATHMCPParams(N=sc.N, dt=sc.dt, tol=1e-3, method='hybrid', max_iters=2)
    solvers = [PATHMCPFrenetApprox(sc.joint_model, sc.costs, sc.agent_constraints,
                                   sc.shared_constraints, sc.bounds, params,
                                   print_method=None, dtype=torch.float64, device=dev)
               for dev in ('cuda', 'cpu')]
    x0, u_ws, _, _ = _sample(sc, 4, 0, torch.float64, 'cpu')
    x0 = torch.as_tensor(x0)
    u0 = solvers[1].problem.stage_to_u(torch.as_tensor(u_ws))
    up = torch.zeros(4, sc.joint_model.n_u, dtype=torch.float64)
    l0 = _dual_warm_start(solvers[1], u0, x0, up)
    res_d = solvers[0].solve_batch(*(a.cuda() for a in (u0, l0, x0, up)))
    res_c = solvers[1].solve_batch(u0, l0, x0, up)
    assert torch.equal(res_d.status.cpu(), res_c.status)
    assert torch.equal(res_d.iters.cpu(), res_c.iters) and int(res_c.iters.min()) > 0
    for f in ('u', 'l', 'res'):
        assert rel_err(getattr(res_d, f).cpu(), getattr(res_c, f)) <= 1e-6, f


@pytest.mark.cuda
def test_dynamic_duel_round_on_the_card_launches_the_kernels_and_matches_cpu_float64():
    """One DGSQP v2 round of the exact dynamic duel (N = 15, 4 games of the study's
    draw) with the study's parameters: float32 on the card, where ``dyn_step`` and both
    linear-algebra kernels launch, against float64 on the CPU, within the parity
    tolerances of ``chip_smoke.py``."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    from chip_smoke import (DERIV_RTOL, STEP_RTOL, dynamic_solver, rel_err,
                            study_batch)
    from dgsqp_torch.harness.dynamic_study import sample_dynamic_duel_initial_conditions
    from dgsqp_torch.harness.scenarios import build_dynamic_duel
    from dgsqp_torch.ops.dynamics import dyn_step
    sc = build_dynamic_duel(N=15)
    sol_d = dynamic_solver(sc, torch.float32, 'cuda')
    sol_c = dynamic_solver(sc, torch.float64, 'cpu')
    batch_d = study_batch(sc, sol_d, 4, sample_dynamic_duel_initial_conditions)
    batch_c = tuple(a.to('cpu', torch.float64) for a in batch_d)
    counts = (linalg.cholesky.launches, linalg.cho_solve.launches, dyn_step.launches)
    c_d0 = sol_d._init_carry(*batch_d)
    c_d = sol_d._make_body(batch_d[2], batch_d[3])(c_d0)
    assert linalg.cholesky.launches > counts[0] and linalg.cho_solve.launches > counts[1]
    assert dyn_step.launches > counts[2]
    c_c = sol_c._make_body(batch_c[2], batch_c[3])(sol_c._init_carry(*batch_c))
    for f in ('status', 'it', 'm_it', 'qp_solves'):
        assert torch.equal(getattr(c_d, f).cpu(), getattr(c_c, f)), f
    assert int(c_d.it.min()) == 1 and not torch.equal(c_d.u, c_d0.u)
    for f, tol in (('p_feas', DERIV_RTOL), ('stat', DERIV_RTOL), ('u', STEP_RTOL)):
        a, b = getattr(c_d, f).to('cpu', torch.float64), getattr(c_c, f)
        assert rel_err(a, b) <= tol, f


@pytest.mark.cuda
def test_dynamic_step_without_kernel_raises_on_the_card():
    """A Frenet dynamic bicycle on a spline track, and a subclass of a dynamic bicycle,
    have no kernel: their step raises on the card instead of running the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    from dgsqp_torch.dynamics import DynamicBicycle, DynamicBicycleConfig, DynamicCLBicycle
    spline = DynamicCLBicycle(0.0, DynamicBicycleConfig(
        dt=0.1, track_name='f1_austin_tenth_scale'))

    class Sub(DynamicBicycle):
        pass
    for m in (spline, Sub(0.0, DynamicBicycleConfig(dt=0.1))):
        q = torch.ones(2, m.n_q, device='cuda')
        u = torch.zeros(2, m.n_u, device='cuda')
        with pytest.raises(ValueError, match='no kernel'):
            m.fd(q, u)


@pytest.mark.cuda
def test_batch_of_one_kernels_match_torch_linalg():
    """The race's planner factors and solves one matrix at a time (B = 1, n = 80 with
    its 56-row polish; k = 1 on the warp path, k = 56 on the column path)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    from chip_smoke import rel_err, spd_batch
    gen = torch.Generator(device='cuda').manual_seed(0)
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        for n, k in ((80, 1), (80, 56), (56, 1)):
            A = spd_batch(1, n, dtype, 'cuda', gen)
            L = linalg.cholesky(A)
            assert rel_err(L.double(), torch.linalg.cholesky(A).double()) <= tol
            b = torch.randn(1, n, k, generator=gen, device='cuda', dtype=dtype)
            b = b[..., 0].contiguous() if k == 1 else b
            x = linalg.cho_solve(L, b)
            ref = torch.cholesky_solve(b[..., None] if k == 1 else b, L)
            assert rel_err(x.double(), ref.reshape(x.shape).double()) <= tol, (n, k)


@pytest.mark.cuda
def test_race_control_step_on_the_card_matches_cpu_float64():
    """One control step of the race (L_track_barc, mpc_N = game_N = 20, float64) on the
    card, where its trackers' rollout and linearization and its plants launch
    ``dyn_step`` and its game planner both linear-algebra kernels, against the same
    step on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    import numpy as np
    from chip_smoke import RACE_ATOL, race_state_vector
    from dgsqp_torch.harness.race import RaceConfig, RaceStack
    from dgsqp_torch.ops.dynamics import dyn_step
    fields = ('x.x', 'x.y', 'v.v_long', 'p.s', 'p.x_tran', 'p.e_psi', 'u.u_a', 'u.u_steer')
    out = {}
    counts = (linalg.cholesky.launches, linalg.cho_solve.launches, dyn_step.launches)
    for device in ('cuda', 'cpu'):
        stack = RaceStack(RaceConfig(), device=device, dtype=torch.float64)
        states = stack.initial_states()
        stack.run(initial_states=states, n_steps=1)
        out[device] = (np.array([race_state_vector(s, fields) for s in states]),
                       [(g['idx'], g['info']['msg']) for g in stack.game_log])
        if device == 'cuda':
            now = (linalg.cholesky.launches, linalg.cho_solve.launches, dyn_step.launches)
            assert all(b > a for a, b in zip(counts, now)), (counts, now)
    np.testing.assert_allclose(out['cuda'][0], out['cpu'][0], rtol=0, atol=RACE_ATOL)
    assert out['cuda'][1] == out['cpu'][1]


@pytest.mark.cuda
def test_tracer_spans_share_the_profilers_clock():
    """A span of the port's tracer whose body launches a few kernels and ends in
    ``torch.cuda.synchronize()``, recorded beside ``torch.profiler``'s device trace:
    every device event of the body lies inside the span's [start, end], within
    ``CLOCK_TOL_NS`` (50 us)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(512, 512, device='cuda')
    y = torch.tanh(x @ x)
    torch.cuda.synchronize()
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof, profiling.tracing():
            with profiling.span('body'):
                for _ in range(4):
                    y = torch.tanh(y @ x)
                torch.cuda.synchronize()
        (body,) = profiling.snapshot()['spans']
    finally:
        profiling.reset()
    events = []
    for e in prof.profiler.kineto_results.events():
        if 'cuda' in str(e.device_type()).lower():
            start, dur = (e.start_ns(), e.duration_ns()) if hasattr(e, 'start_ns') \
                else (e.start_us() * 1000, e.duration_us() * 1000)
            events.append((int(start), int(start + dur)))
    assert len(events) >= 8, events
    early = body['start_ns'] - min(s for s, _ in events)
    late = max(e for _, e in events) - body['end_ns']
    assert early <= CLOCK_TOL_NS and late <= CLOCK_TOL_NS, (early, late)


# ------------------------------------------------------- evaluate's CUDA graphs
def _chicane_inputs(sc, problem, B, seed=0):
    """(u, l, x0, u_prev) of B chicane games (N = 25) in float32 on the card: the
    study's sampler and warm start, duals drawn in [0, 1)."""
    from dgsqp_torch.harness.samplers import sample_duel_initial_conditions
    x0, u_ws, _, _ = sample_duel_initial_conditions(sc, B, seed=seed, dtype=torch.float32,
                                                    device='cuda')
    u = problem.stage_to_u(torch.as_tensor(u_ws, dtype=torch.float32, device='cuda'))
    gen = torch.Generator(device='cuda').manual_seed(seed)
    l = torch.rand(B, problem.n_c_total, generator=gen, device='cuda')
    up = torch.zeros(B, sc.joint_model.n_u, device='cuda')
    return u, l, torch.as_tensor(x0, dtype=torch.float32, device='cuda'), up


def _chicane(B=256):
    """A fresh chicane ``GameProblem`` (no graph yet), its scenario and B games."""
    from dgsqp_torch.harness.scenarios import build_chicane_scenario
    from dgsqp_torch.solvers.game_problem import GameProblem
    sc = build_chicane_scenario(N=25, theta_deg=45.0)
    problem = GameProblem(sc.joint_model, sc.costs, sc.agent_constraints,
                          sc.shared_constraints, sc.bounds, sc.N, dtype=torch.float32,
                          device='cuda')
    return sc, problem, _chicane_inputs(sc, problem, B)


def _graph_counts():
    c = profiling.snapshot()['counters'].get(0, {})
    return tuple(c.get('evaluates.graph.' + k, 0) for k in ('eager', 'capture', 'replay'))


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture
def counted():
    """The tracer on and empty, so that the test reads ``evaluates.graph.*``."""
    profiling.reset()
    with profiling.tracing():
        yield
    profiling.reset()


@pytest.mark.cuda
@pytest.mark.parametrize('hessian', [True, False])
def test_evaluate_replay_matches_eager_to_the_bit(hessian, counted):
    """The chicane at N = 25, B = 256, float32: the first call (eager), the second
    (capture, then replay) and the third (replay) give the same Q, q, G, g and x bit for
    bit; the first-order branch with ``l=None``."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    _, problem, (u, l, x0, up) = _chicane()
    outs = [problem.evaluate(u, l if hessian else None, x0, up, hessian=hessian)
            for _ in range(3)]
    assert _graph_counts() == (1, 1, 1)
    assert len(outs[0]) == (5 if hessian else 4)
    assert _equal(outs[0], outs[1]) and _equal(outs[0], outs[2])


@pytest.mark.cuda
def test_evaluate_replay_of_new_inputs_gives_their_eager_answer(counted):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    sc, problem, call = _chicane()
    first = [problem.evaluate(*call) for _ in range(2)][-1]
    new = _chicane_inputs(sc, problem, 256, seed=1)
    got = problem.evaluate(*new)
    assert _graph_counts() == (1, 1, 1)
    assert _equal(got, problem._evaluate(*new, None, True))
    assert not torch.equal(got[0], first[0])


@pytest.mark.cuda
def test_evaluate_replays_return_fresh_tensors(counted):
    """Two replays' outputs share no storage with each other or with the graph's
    static buffers, and a later replay leaves an earlier call's outputs as they were."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    sc, problem, call = _chicane()
    outs = [problem.evaluate(*call) for _ in range(3)]
    kept = [t.clone() for t in outs[2]]
    outs.append(problem.evaluate(*_chicane_inputs(sc, problem, 256, seed=1)))
    assert _graph_counts() == (1, 1, 2)
    (graph,) = problem._graphs._entries.values()
    ptrs = lambda ts: {t.untyped_storage().data_ptr() for t in ts}
    buffers = ptrs(graph.inputs + graph.outputs)
    assert not ptrs(outs[2]) & ptrs(outs[3])
    assert not (ptrs(outs[2]) | ptrs(outs[3])) & buffers
    assert _equal(outs[2], kept)


@pytest.mark.cuda
def test_evaluate_captures_a_graph_for_each_batch_size(counted):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    sc, problem, call = _chicane()
    small = _chicane_inputs(sc, problem, 128, seed=2)
    for _ in range(3):
        problem.evaluate(*call)
    outs = [problem.evaluate(*small) for _ in range(3)]
    problem.evaluate(*call)
    assert _graph_counts() == (2, 2, 3)
    assert len(problem._graphs._entries) == 2
    assert outs[0][0].shape[0] == 128 and _equal(outs[0], outs[2])


@pytest.mark.cuda
def test_evaluate_inside_an_outer_capture_runs_eager(counted):
    """Captured around by a caller (``chip_smoke.py`` ``graph_ms``,
    ``scripts/torch_profile_batch_scaling.py``), ``evaluate`` issues its own operations
    into the caller's graph, which replays them to the eager answer."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    _, problem, call = _chicane()
    want = [problem.evaluate(*call) for _ in range(2)][0]
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        out = problem.evaluate(*call)
    outer.replay()
    torch.cuda.synchronize()
    assert _graph_counts() == (2, 1, 0)
    assert _equal(out, want)


@pytest.mark.cuda
def test_dynamic_duel_evaluate_replay_counts_its_kernel_launches(counted):
    """The exact dynamic duel (N = 15, 4 games): a replayed ``evaluate`` adds to
    ``dyn_step``'s launch counters what its eager call adds, and gives its answer."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    from chip_smoke import dynamic_solver, study_batch
    from dgsqp_torch.harness.dynamic_study import sample_dynamic_duel_initial_conditions
    from dgsqp_torch.harness.scenarios import build_dynamic_duel
    from dgsqp_torch.ops.dynamics import dyn_step
    sc = build_dynamic_duel(N=15)
    sol = dynamic_solver(sc, torch.float32, 'cuda')
    call = study_batch(sc, sol, 4, sample_dynamic_duel_initial_conditions)
    counts = lambda: (dyn_step.launches, dict(dyn_step.launches_by_order),
                      dict(dyn_step.launches_by_shape))
    profiling.reset()
    added, outs = [], []
    for _ in range(3):
        before = counts()
        outs.append(sol.problem.evaluate(*call))
        after = counts()
        added.append((after[0] - before[0],
                      *({k: n - b.get(k, 0) for k, n in a.items() if n != b.get(k, 0)}
                        for a, b in zip(after[1:], before[1:]))))
    assert _graph_counts() == (1, 1, 1)
    assert added[0][0] > 0 and added[0] == added[1] == added[2]
    assert _equal(outs[0], outs[2])


@pytest.mark.cuda
def test_graph_cache_runs_eager_for_good_where_a_capture_raises(counted):
    """A function that reads the card from the host cannot be captured: its capture
    raises, the call returns the eager answer, the signature stays eager, the current
    stream is the one before, and capture and replay still work for another cache."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    x = torch.arange(4.0, device='cuda')
    stream = torch.cuda.current_stream()
    reads = cuda_graphs.GraphCache('reads')
    outs = [reads(lambda v: v * float(v.sum()), (x,)) for _ in range(3)]
    assert torch.cuda.current_stream() == stream
    assert all(torch.equal(o, x * 6.0) for o in outs)
    plain = cuda_graphs.GraphCache('plain')
    outs = [plain(lambda v: v * 2.0 + 1.0, (x,)) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert all(torch.equal(o, x * 2.0 + 1.0) for o in outs)
    c = profiling.snapshot()['counters'][0]
    assert (c.get('reads.eager'), c.get('reads.capture'), c.get('reads.replay')) == (3, None, None)
    assert (c['plain.eager'], c['plain.capture'], c['plain.replay']) == (1, 1, 1)


@pytest.mark.cuda
def test_graph_cache_counts_signatures_and_captured_bytes(counted):
    """Three calls at each of two widths: a signature is counted the first time it is
    seen, and each capture adds the bytes of the static inputs and outputs its graph
    pins; a replay adds to neither."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    cache = cuda_graphs.GraphCache('g')
    fn = lambda v, w: (v * 2.0 + w, (v * w).sum(-1))
    pinned = 0
    for B in (8, 3):
        args = (torch.rand(B, 5, device='cuda'), torch.rand(B, 5, device='cuda'))
        outs = [cache(fn, args) for _ in range(3)]
        assert all(_equal(o, fn(*args)) for o in outs)
        pinned += 4 * (B * 5 + B * 5) + 4 * (B * 5 + B)
    c = profiling.snapshot()['counters'][0]
    assert (c['g.eager'], c['g.capture'], c['g.replay']) == (2, 2, 2)
    assert c['g.signatures'] == 2 and c['g.captured_bytes'] == pinned
    assert pinned == sum(g.nbytes() for g in cache._entries.values())
