"""The benchmark of ``dgsqp_torch``: Monte-Carlo study batches solved in slices.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration (``configs/<name>.json``:
the game, the solver and every parameter, with the game's plain definition beside it
in ``configs/<game>.py``) and a traffic mix (``workloads/<traffic>.json``: batch width,
chunks a slice, compaction, the pool of batches, the warm-up and the check's sample).
One request is one slice: ``solve_batch_chunked`` on a fresh study batch for a fixed
number of chunks.  One client sends them back to back; every request that starts in the
window is completed, and the rate is all their SQP iterations over all their time.

Per-layer metrics are readers in ``metrics/<name>.py`` (``read(ctx) -> float | None``);
the traced run profiles one request and hands the readers the reduced trace.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the games' plain definitions import one another by module name
if str(BENCH / 'configs') not in sys.path:
    sys.path.insert(0, str(BENCH / 'configs'))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'dgsqp_tpu')
HELD_OUT = BENCH / 'held_out.json'


# ----------------------------------------------------------------------- the spec
def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def held_out() -> dict:
    """Cells, with their configurations, that ``BENCHMARK.json`` leaves out for now
    (``held_out.json``, in its form; PERF.md, Open questions): they run and are checked
    the same way, and report the metrics that name no cells."""
    return json.loads(HELD_OUT.read_text()) if HELD_OUT.is_file() else {}


def load_cell(workload: str, spec_path: Path = ROOT / 'BENCHMARK.json') -> dict:
    """The cell's entry, its configuration and traffic, and the metrics it reports."""
    spec = json.loads(spec_path.read_text())
    held = held_out()
    cells = {w['name']: w for w in held.get('workloads', []) + spec['workloads']}
    if workload not in cells:
        raise KeyError(f'unknown workload {workload!r}; known: {sorted(cells)}')
    cell = cells[workload]
    conf_entry = {c['name']: c for c in held.get('configs', []) + spec['configs']}[cell['config']]
    config = json.loads((ROOT / conf_entry['file']).read_text())
    traffic = json.loads((BENCH / 'workloads' / f"{cell['traffic']}.json").read_text())

    def applies(m):
        return workload in m.get('workloads', [workload])
    return dict(cell=cell, config=config, traffic=traffic,
                end_to_end=[m for m in spec['end_to_end'] if applies(m)],
                per_layer=[m for m in spec['per_layer'] if applies(m)])


def _resolve(dotted: str):
    mod, _, attr = dotted.rpartition('.')
    return getattr(importlib.import_module(mod), attr)


def game_of(config: dict):
    mod = load_module(BENCH / 'configs' / f"{config['game']}.py", f"bench_game_{config['game']}")
    return mod.build({**config['scenario'], **config.get('vehicle', {})})


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """One generator per use of the seed (0: the traffic, 1: the check's samples)."""
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


# ---------------------------------------------------------------- the inputs
def draw_pool(game, traffic: dict, seed: int, device='cpu'):
    """``traffic['pool']`` study batches of ``batch`` games in float64 on ``device``:
    (x0, u0, up) each, the inputs the requests cycle through.  The candidates come from
    the seed on the host; their placement and warm starts are rolled on ``device``."""
    rng = seed_rng(seed, 0)
    pool = []
    for _ in range(int(traffic['pool'])):
        x0, u_ws, up = game.sample(int(traffic['batch']), rng, device)
        pool.append((x0, game.stages_to_u(u_ws), up))
    return pool


# ------------------------------------------------------------- the probe
class Probe:
    """Wrappers the harness puts around the solver's instance lookups: the game's
    ``evaluate`` (host time inside it; the inputs of its last Hessian call), the
    round's ``_qp`` (one call a round: rounds counted; at one round of the first chunk
    the inputs and answers of a sample of games copied for the check) and the round
    itself (``hook``: the state before and after one seeded round and the last round
    of each request, every game, kept for the replay).  With ``trace`` the calls are
    also ``bench.*`` spans of the profile, and the kernels' launch shapes are
    recorded."""

    def __init__(self, solver, trace: bool, hook: str):
        self.eval_s = 0.0
        self.req_rounds = 0
        self.capture_at = None
        self.capture_rows = None
        self.captures = []
        self.round_at = None
        self.rounds = []
        self.shapes = {'chol': [], 'cho_solve': []}
        self._last_eval = None
        self._qp_out = None
        self._round_rec = self._last_rec = None
        self.spans = []
        span = self.span if trace else (lambda n: contextlib.nullcontext())
        evaluate, qp, merit = solver.problem.evaluate, solver._qp, solver.problem.merit_terms

        def evaluate_probe(u, l, x0, up, P=None, hessian=True):
            t0 = time.perf_counter()
            with span('bench.evaluate'):
                out = evaluate(u, l, x0, up, P, hessian)
            self.eval_s += time.perf_counter() - t0
            if hessian:
                self._last_eval = (u, l, x0, up)
            return out

        def qp_probe(Q, q, G, g, *args, **kw):
            with span('bench.qp'):
                out = qp(Q, q, G, g, *args, **kw)
            if self.req_rounds == self.capture_at:
                self._capture(Q, q, G, g, args, out)
            self._qp_out = (self.req_rounds, out)
            self.req_rounds += 1
            return out

        def merit_probe(*args, **kw):
            with span('bench.merit'):
                return merit(*args, **kw)

        solver.problem.evaluate = evaluate_probe
        solver._qp = qp_probe
        if hook == '_round':
            rnd = solver._round

            def round_probe(c, x0, up, P=None):
                out = rnd(c, x0, up, P)
                self._on_round(c, out, x0, up)
                return out
            solver._round = round_probe
        else:
            make_body = solver._make_body

            def make_body_probe(x0, up, P=None):
                body = make_body(x0, up, P)

                def body_probe(c):
                    out = body(c)
                    self._on_round(c, out, x0, up)
                    return out
                return body_probe
            solver._make_body = make_body_probe
        if trace:
            solver.problem.merit_terms = merit_probe
            self._record_shapes()

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span on the wall clock (ns since the epoch, the profiler's clock)."""
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.time_ns(), name))

    def _record_shapes(self):
        from dgsqp_torch.solvers import qp as qp_mod
        chol, cho_solve = qp_mod.cholesky, qp_mod.cho_solve

        def dname(t):
            return str(t.dtype).split('.')[-1]

        def chol_probe(A):
            self.shapes['chol'].append((int(A.shape[0]), int(A.shape[-1]), 0, dname(A)))
            return chol(A)

        def cho_solve_probe(L, b):
            k = 1 if b.dim() == 2 else int(b.shape[-1])
            self.shapes['cho_solve'].append((int(L.shape[0]), int(L.shape[-1]), k, dname(L)))
            return cho_solve(L, b)
        qp_mod.cholesky, qp_mod.cho_solve = chol_probe, cho_solve_probe

    def begin_request(self, capture_at, rows, round_at, request: int = -1):
        self.request = request
        self.req_rounds = 0
        self.shapes = {k: [] for k in self.shapes}
        self.capture_at = capture_at
        self.capture_rows = rows
        self.round_at = round_at
        self._qp_out = None
        self._round_rec = self._last_rec = None

    def end_request(self):
        """Keep the request's seeded round and its last round (references, no copies:
        the program makes a new carry every round), where the request is judged."""
        if self.round_at is None:
            self._round_rec = self._last_rec = None
            return
        recs = [r for r in (self._round_rec, self._last_rec) if r is not None]
        if len(recs) == 2 and recs[0]['k'] == recs[1]['k']:
            recs = recs[1:]
        for r in recs:
            r['last'] = r is self._last_rec
        self.rounds.append(dict(request=self.request, recs=recs, n_rounds=self.req_rounds,
                                capture_at=self.capture_at))
        self._round_rec = self._last_rec = None

    def _on_round(self, c, out, x0, up):
        k = self.req_rounds - 1
        qp = self._qp_out[1] if self._qp_out is not None and self._qp_out[0] == k else None
        rec = dict(k=k, c_in=c, c_out=out, x0=x0, up=up, qp=qp)
        if k == self.round_at:
            self._round_rec = rec
        self._last_rec = rec

    def _capture(self, Q, q, G, g, args, out):
        import torch
        u, l, x0, up = self._last_eval
        n = u.shape[0]
        rows = [r for r in self.capture_rows if r < n]
        idx = torch.as_tensor(rows, device=u.device)
        reg = args[0][idx] if args and hasattr(args[0], 'shape') else None
        self.captures.append(dict(
            u=u[idx], l=l[idx], x0=x0[idx], up=up[idx], Q=Q[idx], q=q[idx], G=G[idx],
            g=g[idx], du=out[0][idx], lam=out[1][idx], reg=reg, request=self.request,
            missing=len(self.capture_rows) - len(rows)))


# ------------------------------------------------------------- the run
def card_and_power_limit(torch):
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=power.limit', '--format=csv,noheader',
                              '--id=0'], capture_output=True, text=True, timeout=30, check=True)
        return name, float(out.stdout.strip().splitlines()[0].split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return name, None


def build_solver(config: dict, device):
    """The program's scenario and solver, built from its public classes with every
    parameter from the configuration."""
    import torch
    port = config['port']
    sc = _resolve(port['scenario'])(**config['scenario'])
    params = _resolve(port['params'])(**config['params'])
    dtype = getattr(torch, config['dtype'])
    solver = _resolve(port['solver'])(sc.joint_model, sc.costs, sc.agent_constraints,
                                      sc.shared_constraints, sc.bounds, params,
                                      print_method=None, dtype=dtype, device=device)
    return sc, solver


def set_tf32(torch, on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def run(workload: str, seed: int, seconds: float, trace: bool, device='cuda',
        t_start: float = None, tf32: bool = False, breaker=None, cell_spec: dict = None,
        also_control: bool = False) -> dict:
    """One run of a cell; returns the result line (without the device block when not
    on the card).  ``tf32`` switches the program's TF32 products on after its
    construction (the control of the QP check); ``also_control`` reads, from the same
    window, the control of the answer and round checks besides: the reference in
    bfloat16 in the program's place (``info.control_readings``); ``breaker(solver)``
    plants a fault under the probe (tests);
    ``cell_spec`` replaces what ``load_cell`` would read (tests at small sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    from dgsqp_torch.harness.mc_study import _dual_warm_start

    spec = cell_spec or load_cell(workload)
    config, traffic = spec['config'], spec['traffic']
    game = game_of(config)

    # ---- set-up: the solver, the pool of study batches, the warm-up
    t_build = time.perf_counter()
    sc, solver = build_solver(config, device)
    set_tf32(torch, tf32)
    dtype = solver.dtype
    t_pool = time.perf_counter()
    pool = []
    drawn = draw_pool(game, traffic, seed, device)
    t_dual = time.perf_counter()
    for x0, u0, up in drawn:
        x0, u0, up = (t.to(device=device, dtype=dtype) for t in (x0, u0, up))
        pool.append((u0, _dual_warm_start(solver, u0, x0, up), x0, up))
    if breaker is not None:
        breaker(solver)
    probe = Probe(solver, trace, round_module(config).HOOK)
    slice_kw = dict(chunk_iters=int(traffic['chunk_iters']),
                    max_chunks=int(traffic['max_chunks']), compact=bool(traffic['compact']))
    warm = traffic['warmup']
    t_warm = time.perf_counter()
    probe.begin_request(None, [], None)
    solver.solve_batch_chunked(*pool[0], chunk_iters=int(warm['chunk_iters']),
                               max_chunks=int(warm['max_chunks']),
                               compact=bool(traffic['compact']))
    _sync(torch, device)
    warmup_s = time.perf_counter() - t_build
    print(f'# set-up: imports {t_build - t_start:.2f} s, solver {t_pool - t_build:.2f} s, '
        f'draw {t_dual - t_pool:.2f} s, dual warm start {t_warm - t_dual:.2f} s, '
        f'warm-up {time.perf_counter() - t_warm:.2f} s',
        file=sys.stderr)

    # ---- the window
    chk = seed_rng(seed, 1)
    # the QP sample's round lies in the first chunk, where every cell still runs all
    # games; the replayed round anywhere in the slice
    chunk_rounds = int(config['rounds_per_chunk_iter']) * slice_kw['chunk_iters']
    slice_rounds = chunk_rounds * slice_kw['max_chunks']
    B = int(traffic['batch'])
    n_qp = int(traffic['check']['qp_games'])
    n_judged = int(traffic['check']['requests'])
    requests = []
    setup_s = time.perf_counter() - t_start
    prof = None
    t_win = time.perf_counter()
    deadline = t_win + seconds
    while not requests or (not trace and time.perf_counter() < deadline):
        i = len(requests)
        if i < n_judged:
            probe.begin_request(int(chk.integers(0, chunk_rounds)),
                                sorted(chk.permutation(B)[:n_qp].tolist()),
                                int(chk.integers(0, slice_rounds)), i)
        else:
            probe.begin_request(None, [], None, i)
        u0, l0, x0, up = pool[i % len(pool)]
        ctx = _profiler(torch, device) if trace else contextlib.nullcontext()
        eval0 = probe.eval_s
        with ctx as prof_i:
            span = probe.span('bench.request') if trace else contextlib.nullcontext()
            t0 = time.perf_counter()
            with span:
                res = solver.solve_batch_chunked(u0, l0, x0, up, **slice_kw)
                iters = int(res.iters.sum())      # the copy to the host ends the request
            t1 = time.perf_counter()
        probe.end_request()
        if trace:
            prof = prof_i
        requests.append(dict(pool=i % len(pool), res=res, iters=iters, t0=t0, t1=t1,
                             rounds=probe.req_rounds, eval_s=probe.eval_s - eval0))
    window_s, total_iters = window_of(requests)
    memory_peak = int(torch.cuda.max_memory_allocated()) if device != 'cpu' else 0

    # ---- the trace, then the check (after the program's state is let go)
    ctx = dict(warmup_s=warmup_s, requests=requests, shapes=probe.shapes)
    captures, rounds = probe.captures, probe.rounds
    t_tr = time.perf_counter()
    if trace:
        import perf_trace
        ctx['trace'] = perf_trace.summarize(prof.profiler.kineto_results.events(),
                                            probe.spans)
        del prof
        print(f"# trace reduced in {time.perf_counter() - t_tr:.1f} s; event kinds "
            f"{ctx['trace']['kinds']}", file=sys.stderr)
    answers = [dict(pool=r['pool'], **{k: getattr(r['res'], k) for k in
                                      ('u', 'l', 'status', 'iters', 'p_feas', 'comp', 'stat')})
               for r in requests]
    for r in requests:
        del r['res']
    del solver, sc, probe, res, prof_i
    if device != 'cpu':
        torch.cuda.empty_cache()
    check = _check(game, config, traffic, pool, answers, captures, rounds, seed, device)
    if also_control:
        check['control'] = _check(game, config, traffic, pool, answers, captures, rounds,
                                  seed, device, 'bf16')['readings']

    line = dict(correct=check['correct'], attempted=len(requests), failed=check['failed'])
    if trace:
        metrics = {}
        for m in spec['per_layer']:
            reader = load_module(BENCH / 'metrics' / f"{m['name']}.py",
                                 f"bench_metric_{m['name']}")
            v = reader.read(ctx)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        e2e = {'game_iters_per_s': total_iters / window_s, 'setup_s': setup_s}
        metrics = {m['name']: {'value': e2e[m['name']], 'unit': m['unit']}
                   for m in spec['end_to_end']}
    line['metrics'] = metrics
    if device != 'cpu':
        name, limit = card_and_power_limit(torch)
        line['device'] = dict(platform='gpu', kind=name, count=1,
                              memory_peak_bytes=memory_peak, power_limit_w=limit)
        if trace:
            tr = ctx['trace']
            line['device'].update(busy_s=tr['busy_ns'] / 1e9, window_s=tr['window_ns'] / 1e9)
    if trace:
        import perf_trace
        tr = ctx['trace']
        line['breakdown'] = dict(device_ops=perf_trace.top(tr['kernel_ns']),
                                 idle_gaps=perf_trace.top(tr['idle_by_host']))
    line['info'] = dict(requests=len(requests), window_s=window_s, total_iters=total_iters,
                        rounds=[r['rounds'] for r in requests],
                        finished=[int((a['status'] != 0).sum()) for a in answers],
                        request_s=[r['t1'] - r['t0'] for r in requests],
                        check_s=check['seconds'],
                        trace_reduce_s=time.perf_counter() - t_tr if trace else None,
                        readings=check['readings'], control_readings=check.get('control'))
    line['checks'] = check['checks']
    return line


def window_of(requests):
    """(seconds from the first request's start to the last one's end, SQP iterations
    of all of them): the rate is all the work over all the time."""
    return (max(r['t1'] for r in requests) - min(r['t0'] for r in requests),
            sum(r['iters'] for r in requests))


def round_module(config: dict):
    """The plain replay of the configuration's round machine, ``rounds/<round>.py``."""
    return load_module(BENCH / 'rounds' / f"{config['round']}.py",
                       f"bench_round_{config['round']}")


def _sync(torch, device):
    if device != 'cpu':
        torch.cuda.synchronize()


def _profiler(torch, device):
    # the card's activity only: a round makes ~10^5 host operations, whose records
    # would cost more than the request; the harness's own spans stand for the host
    acts = [torch.profiler.ProfilerActivity.CPU if device == 'cpu' else
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False,
                                  profile_memory=False)


# ------------------------------------------------------------------- the check
def _check(game, config, traffic, pool, answers, captures, rounds, seed, device,
           control=None) -> dict:
    """Judge the window's answers with the plain reference (``perf_ref``) in float64.

    * ``answer_gap``: at a sample of every request's games (``check.answers``, drawn
      from the seed), the p_feas, comp and stat the program reports for its answer
      (u, l), against the reference's at the same (u, l), each over the scale of its
      terms; the largest.
    Rounds and QPs are judged in the first ``check.requests`` requests, answers in all.

    * ``qp_kkt_p50``: at one round of each request, a sample of games' QP answers
      (``check.qp_games``; step and duals) judged in the reference's QP (its own Q, q,
      G, g at the same iterate, convexified as configured): the median normalised KKT
      residual.
    * ``round_gap``: at one seeded round and at the last round of each request, every
      game's state after the round against the reference's replay of that round
      (``rounds/<round>.py``) from the state before it and the round's QP answer: the
      share of games whose iterate, status, counters or machine mode differ.  At the
      last round the program's answer (u, l, status, iterations) stands in for the
      state where the batch was not compacted.
    * ``eval_gap``: at the QP sample, the program's Q, q, G, g against the reference's
      (reported; compared where the configuration gives a limit).

    A request whose answer never came (no captured round or QP, a sampled game missing
    from it, a non-finite result) is failed, and fails the run.  ``control='bf16'``
    puts the reference in bfloat16 in the program's place for the answers and the
    rounds."""
    import torch
    import perf_ref
    t0 = time.perf_counter()
    f64 = dict(dtype=torch.float64, device=device)
    chk = seed_rng(seed, 2)
    n_ans = int(traffic['check']['answers'])
    params = config['params']
    conv = dict(iters=params['conv_ns_iters'], safety=params['conv_ns_safety'],
                equilibrate=params['conv_ns_equil'])
    bad = set()
    block = int(traffic['check'].get('block', 64))
    keys = ('p_feas', 'comp', 'stat')
    parts = []
    for i, a in enumerate(answers):
        x0_h, up_h = pool[a['pool']][2], pool[a['pool']][3]
        B = a['u'].shape[0]
        rows = torch.as_tensor(np.sort(chk.permutation(B)[:n_ans]), device=a['u'].device)
        if not (torch.isfinite(a['u'][rows]).all() and torch.isfinite(a['l'][rows]).all()):
            bad.add(i)
            continue
        parts.append([a['u'][rows], a['l'][rows], x0_h[rows], up_h[rows]]
                     + [a[k][rows] for k in keys])
    ans_gap = []
    if parts:
        u, l, x0, up, *said_all = (torch.cat(c).to(**f64) for c in zip(*parts))
        for s in range(0, u.shape[0], block):
            sl = slice(s, s + block)
            _, q, G, g = perf_ref.evaluate(game, u[sl], l[sl], x0[sl], up[sl], hessian=False)
            rep, scale = perf_ref.kkt_report(q, G, g, l[sl])
            if control == 'bf16':
                low = [t[sl].to(torch.bfloat16) for t in (u, x0, up, l)]
                _, q_c, G_c, g_c = perf_ref.evaluate(game, low[0], None, low[1], low[2],
                                                     hessian=False)
                said = perf_ref.kkt_report(q_c, G_c, g_c, low[3])[0]
            else:
                said = {k: v[sl] for k, v in zip(keys, said_all)}
            ans_gap.append(torch.stack([(said[k].to(**f64) - rep[k]).abs() / scale[k]
                                        for k in keys]).amax(0))
    qp_res, ev_gap = [], []
    # a request whose QP sample's round came and went without a capture
    bad |= {r['request'] for r in rounds if r['n_rounds'] > r['capture_at']} \
        - {c['request'] for c in captures}
    bad |= {c['request'] for c in captures if c['missing']}
    if captures:
        c = {k: torch.cat([x[k] for x in captures]).to(**f64)
             for k in ('u', 'l', 'x0', 'up', 'Q', 'q', 'G', 'g', 'du', 'lam')}
        reg = torch.cat([x['reg'] for x in captures]).to(**f64) \
            if captures[0]['reg'] is not None else float(params['reg'])
        for s in range(0, c['u'].shape[0], block):
            sl = slice(s, s + block)
            Q, q, G, g = perf_ref.evaluate(game, c['u'][sl], c['l'][sl], c['x0'][sl],
                                           c['up'][sl], hessian=True)
            sym = lambda A: 0.5 * (A + A.transpose(-1, -2))
            ev_gap.append(torch.stack([perf_ref.rel_gap(sym(c['Q'][sl]), sym(Q))]
                                      + [perf_ref.rel_gap(c[k][sl], r)
                                         for k, r in (('q', q), ('G', G), ('g', g))]).amax(0))
            Qh = perf_ref.convexify(Q, reg[sl] if torch.is_tensor(reg) else reg, conv)
            du, lam = c['du'][sl], c['lam'][sl]
            ok = torch.isfinite(du).all(-1) & torch.isfinite(lam).all(-1)
            r = perf_ref.qp_residual(Qh, q, G, g, du, lam)
            qp_res.append(torch.where(ok, r, torch.full_like(r, math.inf)))
    rnd = _round_gap(game, config, answers, rounds, block, device, control)
    bad |= rnd['bad']
    cat = lambda xs: torch.cat(xs).cpu().numpy() if xs else np.zeros(0)
    ans_gap, qp_res, ev_gap = cat(ans_gap), cat(qp_res), cat(ev_gap)
    readings = dict(answer_gap=float(ans_gap.max()) if ans_gap.size else math.inf,
                    qp_kkt_p50=float(np.median(qp_res)) if qp_res.size else math.inf,
                    qp_kkt_max=float(qp_res.max()) if qp_res.size else math.inf,
                    round_gap=rnd['gap'], round_games=rnd['games'],
                    round_fields=rnd['fields'],
                    eval_gap=float(ev_gap.max()) if ev_gap.size else math.inf,
                    answers=int(ans_gap.size), qp_games=int(qp_res.size))
    limits = config['limits']
    checks = {k: {'value': readings[k], 'limit': float(v)} for k, v in limits.items()}
    correct = not bad and all(c['value'] <= c['limit'] for c in checks.values())
    return dict(correct=bool(correct), failed=len(bad), checks=checks, readings=readings,
                seconds=time.perf_counter() - t0)


ROUND_TOL = 1e-4     # relative gap of an iterate that counts as the same


def _round_gap(game, config, answers, rounds, block, device, control=None) -> dict:
    """Replay each request's kept rounds in the reference and count the games whose
    state after the round differs (see ``_check``)."""
    import torch
    mod = round_module(config)
    params = config['params']
    floor = 1e-10 if config['dtype'] == 'float64' else 1e-5
    low = torch.bfloat16 if control == 'bf16' else None
    bad, n_games, n_diff = set(), 0, 0
    fields = {k: 0 for k in mod.EXACT + mod.CLOSE}
    for entry in rounds:
        i, recs = entry['request'], entry['recs']
        a = answers[i]
        if not recs or any(r['qp'] is None for r in recs):
            bad.add(i)
            continue
        for r in recs:
            c_in, c_out = r['c_in']._asdict(), r['c_out']._asdict()
            out = dict(c_out)
            if r['last'] and r['x0'].shape[0] == a['u'].shape[0]:
                # the fixed layout: the answer is the last round's state
                out.update(u=a['u'], l=a['l'], status=a['status'], it=a['iters'])
            qp = dict(du=r['qp'][0], lam=r['qp'][1], ok=r['qp'][2])
            Bk = c_in['u'].shape[0]
            for s in range(0, Bk, block):
                sl = slice(s, s + block)
                take = lambda t, dt=torch.float64: t[sl].to(device=device, dtype=dt) \
                    if torch.is_floating_point(t) else t[sl].to(device)
                x0, up = take(r['x0']), take(r['up'])
                ref = mod.replay(game, params, floor, {k: take(v) for k, v in c_in.items()},
                                 x0, up, {k: take(v) for k, v in qp.items()})
                if low is None:
                    said = {k: take(out[k]) for k in ref}
                else:
                    said = mod.replay(game, params, floor,
                                      {k: take(v, low) for k, v in c_in.items()},
                                      take(r['x0'], low), take(r['up'], low),
                                      {k: take(v, low) for k, v in qp.items()})
                    said = {k: v.to(torch.float64) if torch.is_floating_point(v) else v
                            for k, v in said.items()}
                diff = torch.zeros(x0.shape[0], dtype=torch.bool, device=device)
                for k in mod.EXACT:
                    d = said[k].to(ref[k].dtype) != ref[k]
                    fields[k] += int(d.sum())
                    diff |= d
                for k in mod.CLOSE:
                    x, y = said[k].to(torch.float64), ref[k]
                    same = (x == y) | ((x - y).abs() <= ROUND_TOL * (1.0 + y.abs()))
                    d = ~same.reshape(same.shape[0], -1).all(-1)
                    fields[k] += int(d.sum())
                    diff |= d
                n_games += int(x0.shape[0])
                n_diff += int(diff.sum())
    return dict(bad=bad, gap=n_diff / n_games if n_games else math.inf, games=n_games,
                fields=fields)
