"""The port's tracer (``dgsqp_torch.utils.profiling``) on the CPU.

* Off (the default) it records nothing, and every span it hands out is one shared no-op.
* On, spans nest (parent ids), carry the request a ``new_request`` span opened, and
  counters are kept by request; ``snapshot``, ``reset`` and ``Timers.summary``.
* The solvers' spans and counters in a small chunked solve of the bench chicane (N=5, 4
  games, float64): DGSQP v1's flat machine at the fixed layout and compacting, and DGSQP
  v2.  The span tree is ``solve > chunk > round > {evaluate, qp > {qp.convexify, qp.ipm,
  qp.polish}, merit}`` with ``sync`` spans at the reads, ``chunk.compact`` inside a chunk
  where the batch is compacted; ``rounds == qp_calls``, ``ipm_iters`` is the sum of the
  interior-point loop's trips, and the result is bit for bit the one the same solve
  gives with tracing off.
* ``GameProblem.evaluate``'s CUDA graphs (``dgsqp_torch.utils.cuda_graphs``) on the CPU:
  every call runs eagerly (``evaluates.graph.eager``), the signature keys a call by its
  structure and never by its values, and the launch counters' bookkeeping
  (``dgsqp_torch.ops.linalg`` ``launch_counts``, ``add_launches``).  Capture and
  replay are held on the card in ``tests/test_torch_cuda.py``.
"""
import time

import numpy as np
import pytest
import torch

from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
from dgsqp_torch.solvers import dgsqp, dgsqp_v2
from dgsqp_torch.utils import cuda_graphs, profiling

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

N, BATCH = 5, 4
# tests/test_torch_dgsqp.py's perturbed warm start: the games finish apart, so that a
# compacting solve compacts
SIGMA, NOISE_SEED = 0.5, 2


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def test_tracing_off_records_nothing():
    assert profiling.span('a') is profiling.span('b', 'n') is profiling.sync('site')
    with profiling.span('a', 'n'):
        profiling.count('n', 3)
        assert profiling.read_bool(torch.tensor([False, True]).any(), 'site') is True
        assert profiling.read_numpy(torch.arange(3), 'site').tolist() == [0, 1, 2]
        profiling.count_true('n', torch.tensor([True, False, True]), 'site')
    assert profiling.traced('f', 'calls')(lambda x: x + 1)(1) == 2
    assert profiling.snapshot() == dict(spans=[], counters={})


def test_spans_nest_by_request_and_counters_follow_the_request():
    before = time.time_ns()
    with profiling.tracing() as tracer:
        assert tracer is profiling.TRACER
        profiling.count('outside')
        with profiling.span('solve', new_request=True):
            with profiling.span('chunk', 'chunks'):
                assert profiling.read_bool(torch.tensor(True), 'status')
            profiling.count('rounds', 2)
        with profiling.span('solve', new_request=True):
            profiling.traced('evaluate', 'evaluates')(lambda: None)()
    after = time.time_ns()
    with profiling.span('late'):      # off again: not recorded
        profiling.count('rounds')
    snap = profiling.snapshot()
    spans = {s['id']: s for s in snap['spans']}
    assert [s['name'] for s in snap['spans']] == ['solve', 'chunk', 'sync', 'solve',
                                                  'evaluate']
    assert [s['parent'] for s in snap['spans']] == [0, 1, 2, 0, 4]
    assert [s['request'] for s in snap['spans']] == [1, 1, 1, 2, 2]
    assert all(before <= s['start_ns'] <= s['end_ns'] <= after for s in spans.values())
    assert spans[1]['start_ns'] <= spans[2]['start_ns'] <= spans[2]['end_ns'] \
        <= spans[1]['end_ns']
    assert snap['counters'] == {0: {'outside': 1},
                                1: {'chunks': 1, 'host_syncs': 1, 'host_syncs.status': 1,
                                    'rounds': 2},
                                2: {'evaluates': 1}}
    s = profiling.TRACER.summary()
    assert list(s) == ['chunk', 'evaluate', 'solve', 'sync'] and s['solve']['count'] == 2
    assert s['solve']['mean_s'] == s['solve']['total_s'] / 2
    profiling.reset()
    assert profiling.snapshot() == dict(spans=[], counters={})


@pytest.fixture(scope='module')
def bench():
    out = {}
    for name in ('v1', 'v2'):
        sc, solver = build_bench_solver(horizon=N, solver_name=name, dtype=torch.float64,
                                        device='cpu')
        out[name] = solver, build_bench_batch(sc, solver, BATCH, seed=0)
    return out


def _paths(spans):
    by_id = {s['id']: s for s in spans}

    def path(s):
        return (path(by_id[s['parent']]) + ' > ' if s['parent'] else '') + s['name']
    return {path(s) for s in spans}


ROUND = ['solve > chunk > round > ' + p for p in
         ('evaluate', 'qp', 'qp > qp.convexify', 'qp > qp.ipm', 'qp > qp.ipm > sync',
          'qp > qp.polish')]
SOLVES = {
    # name: (solver, solve_batch_chunked's keywords, spans beside the round's)
    'v1_fixed': ('v1', dict(chunk_iters=1, max_chunks=2, compact=False),
                 ['solve > chunk > sync', 'solve > chunk > round > merit']),
    'v1_compacting': ('v1', dict(chunk_iters=1, max_chunks=2, compact=True),
                      ['solve > chunk > sync', 'solve > chunk > chunk.compact',
                       'solve > chunk > chunk.compact > sync',
                       'solve > chunk > round > merit']),
    'v2': ('v2', dict(chunk_iters=2, max_chunks=2),
           ['solve > chunk > round > trial', 'solve > chunk > round > trial > sync']),
}


@pytest.mark.parametrize('case', sorted(SOLVES))
def test_solver_spans_and_counters(bench, case, monkeypatch):
    name, kw, extra = SOLVES[case]
    solver, batch = bench[name]
    if case == 'v1_compacting':
        monkeypatch.setattr(solver, '_compact_min_bucket', 1)
        u0, *rest = batch
        noise = SIGMA * np.random.default_rng(NOISE_SEED).standard_normal(tuple(u0.shape))
        batch = (u0 + torch.as_tensor(noise), *rest)
    res_off = solver.solve_batch_chunked(*batch, **kw)
    assert profiling.snapshot() == dict(spans=[], counters={})

    trips = []
    mod = dgsqp if name == 'v1' else dgsqp_v2
    solve_qp = mod.solve_qp

    def counting_qp(*args, **kwargs):
        sol = solve_qp(*args, **kwargs)
        trips.append(int(sol.iters.max()))       # every game starts active
        return sol
    monkeypatch.setattr(mod, 'solve_qp', counting_qp)
    with profiling.tracing():
        res_on = solver.solve_batch_chunked(*batch, **kw)
    for f in ('u', 'l', 'status', 'iters'):
        assert torch.equal(getattr(res_on, f), getattr(res_off, f)), f

    snap = profiling.snapshot()
    spans = snap['spans']
    assert set(snap['counters']) == {1} and {s['request'] for s in spans} == {1}
    c = snap['counters'][1]
    paths = _paths(spans)
    assert set(ROUND + extra + ['solve', 'solve > chunk', 'solve > chunk > round']) <= paths
    for s in spans:
        parent = {x['id']: x['name'] for x in spans}.get(s['parent'])
        if '.' in s['name']:
            assert parent == s['name'].rsplit('.', 1)[0]
        if s['name'] == 'sync':
            assert parent in ('solve', 'chunk', 'chunk.compact', 'round', 'qp.ipm', 'merit',
                              'trial')
    n = lambda key: sum(s['name'] == key for s in spans)
    assert c['rounds'] == c['qp_calls'] == n('round') == n('qp') == len(trips) > 0
    assert c['ipm_iters'] == sum(trips)
    assert c['host_syncs.ipm.active'] == c['ipm_iters'] + c['qp_calls']
    assert c['host_syncs'] == n('sync') == sum(v for k, v in c.items()
                                               if k.startswith('host_syncs.'))
    assert c['chunks'] == n('chunk') == len(solver.last_chunk_history)
    assert c['evaluates'] == n('evaluate') \
        == c['evaluates.ad.hessian'] + c['evaluates.ad.first']
    assert c['evaluates.ad.hessian'] == c['rounds']
    assert c['evaluates.graph.eager'] == c['evaluates']     # no graph on the CPU
    # v1 searches in every round, v2 in the rounds where a game takes an m-step; the
    # grid reads nothing but its traced count, eagerly
    assert n('merit') == (c['rounds'] if name == 'v1' else c.get('trials', 0))
    assert 'host_syncs.merit.select' not in c
    assert c.get('merits.graph.eager', 0) == n('merit') == c.get('host_syncs.merit.games', 0)
    assert 'merits.graph.capture' not in c and 'merits.graph.replay' not in c
    assert c.get('compactions', 0) == n('chunk.compact') == (case == 'v1_compacting')


@pytest.fixture(scope='module')
def approx():
    """The approximate (MPCC) duel's bench solver, v2-Frenet, at N = 6 and its 4-game
    seed-0 batch in float64."""
    sc, solver = build_bench_solver(horizon=6, solver_name='approx', dtype=torch.float64,
                                    device='cpu')
    return solver, build_bench_batch(sc, solver, BATCH, seed=0)


def test_v2_trial_and_merit_counters_follow_the_rounds(approx, monkeypatch):
    """``trials``, ``trial_games``, ``merit_games`` and ``merit_points`` against the masks
    that each round's carries before and after it, and its QP answer, imply: a game went
    on where its iteration count grew, took an m-step (and so the full-step trial) where
    its m-step count grew, and went to the line search where that trial's merit missed
    the non-monotone reference.  With tracing off the solve gives the same bits."""
    solver, batch = approx
    # rounds enough for the games to finish apart (benchmark/test_perf_faults.py's)
    kw = dict(chunk_iters=8, max_chunks=2, compact=False)
    res_off = solver.solve_batch_chunked(*batch, **kw)
    seen, answers = [], []
    make_body, qp = solver._make_body, solver._qp

    def recording_body(x0, up, P=None):
        body = make_body(x0, up, P)

        def rec(c):
            out = body(c)
            seen.append((c, out, x0, up))
            return out
        return rec

    def recording_qp(*args):
        out = qp(*args)
        answers.append(out)
        return out
    monkeypatch.setattr(solver, '_make_body', recording_body)
    monkeypatch.setattr(solver, '_qp', recording_qp)
    with profiling.tracing():
        res_on = solver.solve_batch_chunked(*batch, **kw)
    for f in res_off._fields:
        assert torch.equal(getattr(res_on, f), getattr(res_off, f)), f

    snap = profiling.snapshot()
    c = snap['counters'][1]
    p = solver.params
    want = dict(trials=0, trial_games=0, merit_games=0)
    for (before, after, x0, up), (du, lam, ok) in zip(seen, answers, strict=True):
        assert bool(ok.all())          # no QP-failure recovery in this batch
        mstep = after.m_it > before.m_it
        assert bool((mstep <= (after.it > before.it)).all())
        sel = torch.nonzero(mstep).flatten()
        want['trials'] += int(sel.numel() > 0)
        want['trial_games'] += int(sel.numel())
        if not sel.numel():
            continue
        u_full = (before.u + du)[sel]
        l_full = (before.l + (lam - before.l))[sel]
        q, G, g, _ = solver.problem.evaluate(u_full, l_full, x0[sel], up[sel], None,
                                             hessian=False)
        phi_full = solver._phi(l_full, torch.clamp(g, min=0.0), q, G, g, 1.0, True)
        R = (1 - p.merit_decrease) * before.memory.amax(-1)[sel]
        want['merit_games'] += int((phi_full > R).sum())
    assert want['trials'] > 0 and 0 < want['merit_games'] < want['trial_games']
    assert want['trial_games'] < BATCH * len(seen)     # not every game in every trial
    assert {k: c[k] for k in want} == want
    # the grid runs in each round with a trial, at the batch's full width, which nothing
    # compacts here, and reads only the count of its games
    assert c['merit_points'] == p.line_search_iters * BATCH * want['trials']
    n = lambda key: sum(s['name'] == key for s in snap['spans'])
    assert n('trial') == n('round') == c['rounds'] == len(seen)
    assert c['host_syncs.trial.select'] == c['rounds']
    assert c['host_syncs.merit.games'] == n('merit') == c['merits.graph.eager'] \
        == want['trials']
    assert c.get('host_syncs.merit.select', 0) == 0


# ------------------------------------------------------- evaluate's CUDA graphs
def test_evaluate_on_the_cpu_never_captures(bench):
    solver, (u0, l0, x0, up) = bench['v1']
    problem = solver.problem
    with profiling.tracing():
        hess = [problem.evaluate(u0, l0, x0, up) for _ in range(3)]
        first = [problem.evaluate(u0, None, x0, up, hessian=False) for _ in range(3)]
    c = profiling.snapshot()['counters'][0]
    assert c['evaluates.graph.eager'] == c['evaluates'] == 6
    assert 'evaluates.graph.capture' not in c and 'evaluates.graph.replay' not in c
    assert problem._graphs._entries == {}
    for outs in (hess, first):
        for out in outs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(outs[0], out))


def _call(B=4, dtype=torch.float64, l=True, hessian=True, P='pair', seed=0):
    """Arguments of an evaluate-like call (u, l, x0, u_prev, P) and its flag."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g, dtype=dtype)
    Ps = {'none': None, 'pair': {'a': r(B, 3), 'b': [r(B, 6, 2)]},
          'more': {'a': r(B, 3), 'b': [r(B, 6, 2), r(B, 6, 2)]},
          'wider': {'a': r(B, 4), 'b': [r(B, 6, 2)]},
          'float': {'a': r(B, 3), 'b': [0.5]}}
    return (r(B, 20), r(B, 105) if l else None, r(B, 12), r(B, 4), Ps[P]), hessian


SIGNATURES = {
    # name: (keywords of _call, or a function of the base call's arguments; the key it
    # gives: the base call's, a new one, or none)
    'values': (dict(seed=1), 'same'),
    'batch': (dict(B=3), 'new'),
    'dtype': (dict(dtype=torch.float32), 'new'),
    'l_none': (dict(l=False), 'new'),
    'first_order': (dict(hessian=False), 'new'),
    'P_none': (dict(P='none'), 'new'),
    'P_structure': (dict(P='more'), 'new'),
    'P_shape': (dict(P='wider'), 'new'),
    'strides': (lambda a: ((a[0].t().contiguous().t(),) + a[1:]), 'new'),
    'P_not_tensors': (dict(P='float'), 'none'),
}


@pytest.mark.parametrize('case', sorted(SIGNATURES))
def test_graph_signature_keys_structure_not_values(case):
    change, expect = SIGNATURES[case]
    args, flag = _call()
    base = cuda_graphs.signature(args, flag)
    if callable(change):
        key = cuda_graphs.signature(change(args), flag)
    else:
        key = cuda_graphs.signature(*_call(**change))
    assert base is not None and hash(base) == hash(cuda_graphs.signature(*_call()))
    assert {'same': key == base, 'new': key is not None and key != base,
            'none': key is None}[expect]


def test_launch_counts_add_and_take_back():
    from dgsqp_torch.ops.dynamics import dyn_step as dyn
    from dgsqp_torch.ops.linalg import add_launches, cho_solve, cholesky, launch_counts
    before = launch_counts()
    assert {(k, name) for k, name, key in before if key is None} \
        == {(k, 'launches') for k in (dyn, cholesky, cho_solve)}
    delta = {(dyn, 'launches', None): 3, (dyn, 'launches_by_shape', 'order2_P7'): 3}
    add_launches(delta)
    after = launch_counts()
    assert after[(dyn, 'launches', None)] == before[(dyn, 'launches', None)] + 3
    assert after[(dyn, 'launches_by_shape', 'order2_P7')] \
        == before.get((dyn, 'launches_by_shape', 'order2_P7'), 0) + 3
    add_launches(delta, -1)
    if (dyn, 'launches_by_shape', 'order2_P7') not in before:
        del dyn.launches_by_shape['order2_P7']
    assert launch_counts() == before


def test_every_kernel_wrapper_registers_its_launch_counters():
    """Every function of ``dgsqp_torch.ops`` that counts launches (an attribute whose
    name starts with ``launches``) has all of them registered, so that a replayed CUDA
    graph adds to each what its capture added."""
    import importlib
    import pkgutil

    import dgsqp_torch.ops
    from dgsqp_torch.ops import linalg
    registered = {(w, name) for w, names in linalg._launch_counters for name in names}
    counting = set()
    for info in pkgutil.iter_modules(dgsqp_torch.ops.__path__):
        module = importlib.import_module(f'dgsqp_torch.ops.{info.name}')
        for fn in vars(module).values():
            if callable(fn) and getattr(fn, '__module__', None) == module.__name__:
                counting |= {(fn, a) for a in vars(fn) if a.startswith('launches')}
    assert len(counting) == 7 and counting == registered
