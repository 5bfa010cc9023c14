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
"""
import time

import numpy as np
import pytest
import torch

from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
from dgsqp_torch.solvers import dgsqp, dgsqp_v2
from dgsqp_torch.utils import profiling

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
          'qp > qp.polish', 'merit')]
SOLVES = {
    # name: (solver, solve_batch_chunked's keywords, spans beside the round's)
    'v1_fixed': ('v1', dict(chunk_iters=1, max_chunks=2, compact=False),
                 ['solve > chunk > sync']),
    'v1_compacting': ('v1', dict(chunk_iters=1, max_chunks=2, compact=True),
                      ['solve > chunk > sync', 'solve > chunk > chunk.compact',
                       'solve > chunk > chunk.compact > sync']),
    'v2': ('v2', dict(chunk_iters=2, max_chunks=2), ['solve > chunk > round > sync']),
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
            assert parent in ('solve', 'chunk', 'chunk.compact', 'round', 'qp.ipm', 'merit')
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
    assert c.get('compactions', 0) == n('chunk.compact') == (case == 'v1_compacting')
