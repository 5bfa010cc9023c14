"""CPU tests of the readers of the idle time under a host span, ``evaluate_idle_pct`` and
``merit_idle_pct``, on a trace reduced from synthetic device events and harness spans.
``python -m pytest benchmark -p no:xdist -o addopts= -q``."""
import importlib.util
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import perf_trace  # noqa: E402
from test_perf_harness import _Ev  # noqa: E402

SPEC = json.loads((ROOT / 'BENCHMARK.json').read_text())


def _reader(name):
    spec = importlib.util.spec_from_file_location(f'bench_metric_{name}',
                                                  BENCH / 'metrics' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _trace(spans):
    # busy 100-170 and 300-400 of a 1000 ns request
    events = [_Ev('k1', 100, 50), _Ev('k2', 120, 50),
              _Ev('Memcpy HtoD', 300, 100, kind='gpu_memcpy')]
    return {'trace': perf_trace.summarize(events, [(0, 1000, 'bench.request')] + spans)}


@pytest.mark.parametrize('name,span', [('evaluate_idle_pct', 'evaluate'),
                                       ('merit_idle_pct', 'merit')])
def test_reader_gives_its_spans_idle_share(name, span):
    # the span holds the middles of the gaps 0-100 and 170-300 (the device's busy time
    # inside it does not count), the qp span that of the gap 400-1000
    ctx = _trace([(0, 250, 'bench.' + span), (250, 1000, 'bench.qp')])
    assert ctx['trace']['idle_by_host'] == {span: 100 + 130, 'qp': 600}
    assert _reader(name)(ctx) == pytest.approx(23.0)
    # nested inside the qp span over that gap's middle, the innermost span takes it
    ctx = _trace([(0, 250, 'bench.' + span), (250, 1000, 'bench.qp'),
                  (650, 750, 'bench.' + span)])
    assert ctx['trace']['idle_by_host'] == {span: 100 + 130 + 600}
    assert _reader(name)(ctx) == pytest.approx(83.0)


@pytest.mark.parametrize('name', ['evaluate_idle_pct', 'merit_idle_pct'])
def test_reader_gives_nothing_without_its_span(name):
    other = 'bench.qp' if name.startswith('evaluate') else 'bench.evaluate'
    assert _reader(name)(_trace([(0, 1000, other)])) is None
    assert _reader(name)(_trace([])) is None


def test_the_readers_name_the_mpcc_cell_and_the_faults_take_it():
    import test_perf_faults
    for name in ('evaluate_idle_pct', 'merit_idle_pct'):
        (entry,) = [m for m in SPEC['per_layer'] if m['name'] == name]
        assert entry['workloads'] == ['approx_duel.b1024']
        assert entry['moves'] == 'game_iters_per_s'
    # one cell a configuration: the benchmark's own before a held-out one
    assert sorted(test_perf_faults.CELLS) == ['approx_duel.b1024', 'chicane_v1.b256']
