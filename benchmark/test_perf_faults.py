"""The check that decides ``correct``, driven through a whole run on the CPU at a test
size with the timed path broken underneath: every fault has to come out not correct,
and the sound program correct.  The card's control (TF32 products) is the ``cuda``
test at the end; at the cells' own size it runs as ``benchmark/readings.py --tf32 1``.
``python -m pytest benchmark -p no:xdist -o addopts= -q``."""
import copy
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import perf_harness  # noqa: E402

SPEC = json.loads((ROOT / 'BENCHMARK.json').read_text())
WORKLOADS = SPEC['workloads'] + perf_harness.held_out().get('workloads', [])
# one cell a configuration: the faults are the configuration's, not the traffic's
CELLS = list({w['config']: w['name'] for w in reversed(WORKLOADS)}.values())


# rounds a request at the test size: every game of the batch finishes in them
TEST_ROUNDS = {'v1_flat': dict(chunk_iters=1, max_chunks=1),
               'v2': dict(chunk_iters=8, max_chunks=2)}


def small_cell(workload: str, N: int = 6, batch: int = 4) -> dict:
    """The cell at a test size: horizon N, a small batch, one request of a few rounds
    in which the games finish, every answer and two QPs judged."""
    spec = copy.deepcopy(perf_harness.load_cell(workload))
    spec['config']['scenario']['N'] = N
    spec['config']['params']['N'] = N
    spec['traffic'].update(batch=batch, pool=1, **TEST_ROUNDS[spec['config']['round']],
                           warmup=dict(chunk_iters=1, max_chunks=1),
                           check=dict(answers=batch, qp_games=max(2, batch // 4), requests=1,
                                      block=batch))
    return spec


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(workload, breaker=None, also_control=False):
    return perf_harness.run(workload, 2 ** 31 + 4242, 0.1, False, device='cpu',
                            cell_spec=small_cell(workload), breaker=breaker,
                            also_control=also_control)


def step_unchanged(solver):
    """A round (or v2 body) that returns its state unchanged."""
    if hasattr(solver, '_round'):
        solver._round = lambda c, x0, up, P=None: c
    solver._make_body = lambda x0, up, P=None: (lambda c: c)


def _wrap_round(solver, edit):
    """Plant ``edit(state before, state after) -> state`` under every round."""
    if hasattr(solver, '_round'):
        rnd = solver._round
        solver._round = lambda c, x0, up, P=None: edit(c, rnd(c, x0, up, P))
    else:
        make_body = solver._make_body

        def broken(x0, up, P=None):
            body = make_body(x0, up, P)
            return lambda c: edit(c, body(c))
        solver._make_body = broken


def step_discarded(solver):
    """The round runs, its QP included, but its new state is thrown away: the game
    keeps its iterate, with the iteration counters advanced."""
    def edit(c, out):
        kept = {k: getattr(out, k) for k in ('it', 'm_it', 'qp_solves') if hasattr(out, k)}
        return c._replace(**kept)
    _wrap_round(solver, edit)


def never_finished(solver):
    """No game is ever marked finished: a status the round sets goes back to running."""
    def edit(c, out):
        return out._replace(status=out.status.new_zeros(out.status.shape))
    _wrap_round(solver, edit)


def _wrap_solve(solver, edit):
    solve = solver.solve_batch_chunked

    def broken(u0, l0, x0, up, **kw):
        return edit(solve, u0, l0, x0, up, kw)
    solver.solve_batch_chunked = broken


def half_batch(solver):
    """Half of the batch left out: the solver sees the first half, the rest comes back
    as it went in, with nothing converged and nought residuals."""
    def edit(solve, u0, l0, x0, up, kw):
        h = u0.shape[0] // 2
        res = solve(u0[:h], l0[:h], x0[:h], up[:h], **kw)
        cat = lambda a, b: __import__('torch').cat([a, b])
        z = lambda a: a.new_zeros((u0.shape[0] - h,) + a.shape[1:])
        return type(res)(cat(res.u, u0[h:]), cat(res.l, l0[h:]), cat(res.status, z(res.status)),
                         cat(res.iters, z(res.iters)), cat(res.qp_solves, z(res.qp_solves)),
                         cat(res.p_feas, z(res.p_feas)), cat(res.comp, z(res.comp)),
                         cat(res.stat, z(res.stat)))
    _wrap_solve(solver, edit)


def answer_altered(solver):
    """One game's answer altered where it is produced: its row of u and l comes back
    as another game's, its reported residuals as its own."""
    def edit(solve, u0, l0, x0, up, kw):
        res = solve(u0, l0, x0, up, **kw)
        u, l = res.u.clone(), res.l.clone()
        u[1], l[1] = res.u[2], res.l[2]
        return res._replace(u=u, l=l)
    _wrap_solve(solver, edit)


@pytest.mark.parametrize('workload', CELLS)
def test_the_sound_program_is_correct(workload):
    line = _run(workload)
    assert line['correct'], line['checks']
    readings = line['info']['readings']
    assert readings['answers'] == 4 and readings['qp_games'] == 2
    assert readings['round_gap'] == 0 and readings['round_games'] >= 4
    # the faults below that keep games running have something to show
    assert line['info']['finished'][0] > 0


@pytest.mark.parametrize('workload', CELLS)
def test_the_bf16_reference_in_the_programs_place_is_not_correct(workload):
    line = _run(workload, also_control=True)
    assert line['correct'], line['checks']
    control = line['info']['control_readings']
    for name in ('answer_gap', 'round_gap'):
        assert control[name] > line['checks'][name]['limit'], name


@pytest.mark.parametrize('fault', [step_unchanged, step_discarded, never_finished,
                                   half_batch, answer_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize('workload', CELLS)
def test_every_fault_is_not_correct(workload, fault):
    line = _run(workload, breaker=fault)
    assert not line['correct'], (fault.__name__, line['checks'], line['failed'])
    # each is caught by the number made for it: a round that never came fails the
    # request; a round's state by the replay; an answer by the reference's residuals
    caught = {'step_unchanged': line['failed'] > 0,
              'step_discarded': _over(line, 'round_gap'),
              'never_finished': _over(line, 'round_gap'),
              'half_batch': _over(line, 'answer_gap'),
              'answer_altered': _over(line, 'answer_gap')}
    assert caught[fault.__name__], (line['checks'], line['failed'])


def _over(line, name):
    return line['checks'][name]['value'] > line['checks'][name]['limit']


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: TF32 exists only on the card')
    return 'cuda'


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_the_tf32_control_is_not_correct(workload, card):
    # the cell itself, as committed, with one request
    lines = [perf_harness.run(workload, 2 ** 31 + 4242, 0.1, False, device=card, tf32=tf32)
             for tf32 in (False, True)]
    assert lines[0]['correct'], lines[0]['checks']
    assert not lines[1]['correct'], lines[1]['checks']
