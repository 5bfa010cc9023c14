"""CPU tests of the benchmark's yardstick: the specification and its files, the rate
arithmetic, the idle share, the roofline, the seeded draw, and what the benchmark may
import.  ``python -m pytest benchmark -p no:xdist -o addopts= -q``."""
import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import perf_harness  # noqa: E402
import perf_roofline  # noqa: E402
import perf_trace  # noqa: E402

SPEC = json.loads((ROOT / 'BENCHMARK.json').read_text())
HELD = perf_harness.held_out()


@pytest.mark.parametrize('workload', [w['name'] for w in SPEC['workloads'] + HELD['workloads']])
def test_every_cell_loads_by_name(workload):
    cell = perf_harness.load_cell(workload)
    assert cell['cell']['config'] == cell['config']['name']
    for key in ('batch', 'chunk_iters', 'max_chunks', 'compact', 'pool', 'warmup', 'check'):
        assert key in cell['traffic']
    assert {m['name'] for m in cell['end_to_end']} >= {'setup_s'}
    assert cell['per_layer']
    for m in cell['per_layer']:
        assert (BENCH / 'metrics' / f"{m['name']}.py").is_file()


@pytest.mark.parametrize('entry', SPEC['configs'] + HELD['configs'], ids=lambda c: c['name'])
def test_every_configuration_builds_its_game(entry):
    config = json.loads((ROOT / entry['file']).read_text())
    assert config['name'] == entry['name']
    game = perf_harness.game_of(config)
    assert game.n_dec == config['params']['N'] * game.n_u
    assert set(config['limits']) and all(v > 0 for v in config['limits'].values())
    # the replay of its round machine is found by name, and the departures from the
    # source are listed in the file (the cuts of scale in BENCHMARK.json's `reduced`)
    assert perf_harness.round_module(config).HOOK in ('_round', '_make_body')
    assert all(isinstance(a, str) and a for a in config['assumed'])


def test_rate_is_all_work_over_all_time():
    reqs = [dict(t0=10.0, t1=14.0, iters=400), dict(t0=14.0, t1=19.0, iters=1000),
            dict(t0=19.0, t1=22.0, iters=300)]
    window, iters = perf_harness.window_of(reqs)
    assert window == pytest.approx(12.0) and iters == 1700
    # not the mean of the requests' own rates
    assert iters / window != pytest.approx(np.mean([r['iters'] / (r['t1'] - r['t0'])
                                                    for r in reqs]))


def test_merged_intervals_count_overlap_once():
    s, e = perf_trace.merge_intervals([0, 5, 2, 20, 21], [3, 8, 4, 25, 22])
    assert s.tolist() == [0, 5, 20] and e.tolist() == [4, 8, 25]
    assert perf_trace.busy_ns([0, 5, 2, 20], [3, 8, 4, 25]) == 4 + 3 + 5
    assert perf_trace.busy_ns([0, 5, 2, 20], [3, 8, 4, 25], lo=1, hi=22) == 3 + 3 + 2


class _Ev:
    def __init__(self, name, start, dur, dev='DeviceType.CUDA', kind='kernel'):
        self._a = (name, start, dur, dev, kind)

    def name(self):
        return self._a[0]

    def start_ns(self):
        return self._a[1]

    def duration_ns(self):
        return self._a[2]

    def device_type(self):
        return self._a[3]

    def activity_type(self):
        return self._a[4]


def test_idle_share_and_gaps_from_a_trace():
    events = [_Ev('k1', 100, 50), _Ev('k2', 120, 50), _Ev('Memcpy HtoD', 300, 100,
                                                           kind='gpu_memcpy'),
              _Ev('cudaLaunchKernel', 90, 5, dev='DeviceType.CPU', kind='cuda_runtime'),
              _Ev('bench.qp', 0, 0, kind='gpu_user_annotation')]
    spans = [(0, 1000, 'bench.request'), (0, 250, 'bench.evaluate'),
             (250, 1000, 'bench.qp')]
    tr = perf_trace.summarize(events, spans)
    assert tr['window_ns'] == 1000 and tr['busy_ns'] == 70 + 100
    assert tr['device_events'] == 3
    assert tr['idle_by_host'] == {'evaluate': 100 + 130, 'qp': 600}
    assert sum(tr['idle_by_host'].values()) == tr['window_ns'] - tr['busy_ns']
    import importlib.util
    spec = importlib.util.spec_from_file_location('r', BENCH / 'metrics' / 'device_idle_pct.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read({'trace': tr}) == pytest.approx(83.0)


def test_roofline_against_the_frozen_bound():
    # chol at (256, 100, 100) in float32: bytes 256 * (5050 + 10000) * 4 over 3.35 TB/s
    # against 256 * 100^3 / 3 operations over 67 TFLOP/s
    b = perf_roofline.bound_s('chol', 256, 100, 0, 'float32')
    assert b == pytest.approx(max(256 * 15050 * 4 / 3.35e12, 256 * 1e6 / 3 / 67e12))
    # cho_solve (256, 150) with 96 right-hand sides: operation-bound
    b2 = perf_roofline.bound_s('cho_solve', 256, 150, 96, 'float32')
    assert b2 == pytest.approx(2 * 256 * 150 ** 2 * 96 / 67e12)
    shapes = [(256, 100, 0, 'float32')] * 3
    seq = [('void chol_kernel<float>(...)', 10_000)] * 3 + \
        [('void cho_solve_warp_kernel<float>(...)', 5_000)]
    assert perf_roofline.roofline_pct('chol', shapes, seq) == pytest.approx(
        100 * 3 * b / 30e-6)
    # a launch the trace lost (or one the harness did not record) gives no number
    assert perf_roofline.roofline_pct('chol', shapes[:2], seq) is None
    assert perf_roofline.roofline_pct('cho_solve', [], seq) is None


@pytest.mark.parametrize('seed', [7, 2 ** 31 + 98765])
def test_draw_is_deterministic_in_the_seed(seed):
    cell = perf_harness.load_cell('chicane_v1.b256')
    game = perf_harness.game_of(cell['config'])
    traffic = dict(cell['traffic'], batch=6, pool=2)
    a = perf_harness.draw_pool(game, traffic, seed)
    b = perf_harness.draw_pool(game, traffic, seed)
    c = perf_harness.draw_pool(game, traffic, seed + 1)
    for pa, pb, pc in zip(a, b, c):
        for ta, tb, tc in zip(pa, pb, pc):
            assert ta.shape[0] == 6 and bool((ta == tb).all())
        assert not bool((pa[0] == pc[0]).all())
    assert not bool((a[0][0] == a[1][0]).all())    # the pool's batches differ


FORBIDDEN = {'jax', 'jaxlib', 'flax', 'dgsqp_tpu'}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split('.')[0])
        elif isinstance(node, ast.Call) and getattr(node.func, 'attr', getattr(
                node.func, 'id', None)) in ('import_module', '__import__'):
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split('.')[0])
    return names


@pytest.mark.parametrize('path', sorted(BENCH.rglob('*.py')), ids=lambda p: p.name)
def test_nothing_imports_jax(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize('path', [BENCH / 'perf_ref.py'] + sorted(BENCH.glob('configs/*.py')),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = _imports(path)
    assert 'dgsqp_torch' not in names and not names & FORBIDDEN
    assert names <= {'__future__', 'math', 'numpy', 'torch', 'chicane_game'}


def test_dotted_names_compare_whole():
    # the port's name begins with the JAX package's: only whole top-level names count
    assert 'dgsqp_torch'.split('.')[0] not in FORBIDDEN
    assert 'dgsqp_tpu.solvers'.split('.')[0] in FORBIDDEN
