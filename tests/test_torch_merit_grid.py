"""The line search's merit grid at the batch's full width, on the CPU in float64.

DGSQP v1's ``_grid_ls`` and v2's ``_line_search`` evaluate every game's trials and mask
the games that are not enabled (``torch.where``), so that the grid's shapes do not change
from round to round and, on the card, it replays a CUDA graph per input signature
(``merits.graph.*``).  Each is held here against a copy of the grid it replaced, which
read the enabled games back to the host and evaluated only theirs (kept below): the same
(u, l, phi) to 1e-12 when all, some and no games are enabled, for v2 with each of its
references (Armijo with the checkpoint's reference for stale games, with the merit
memory's, Armijo alone, the non-monotone ``'max'``) and, on the approximate game, with the
parameters repeated per trial (``approximation_eval='once'``) or re-linearized at each
trial point (``'always'``).  A disabled game whose step is not finite leaves the enabled
games' answers as they were.  Capture and replay are held on the card in
``tests/test_torch_cuda.py``.
"""
import math

import pytest
import torch

from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
from dgsqp_torch.solvers.dgsqp import _get_mu, _merit_dphi, _merit_phi, _merit_phi_dg
from dgsqp_torch.solvers.dgsqp_v2 import _rows
from dgsqp_torch.utils import profiling

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

N, BATCH = 5, 6
TOL = 1e-12
# which games are enabled: every one, games 0, 2 and 5 (game 1, disabled, gets a step
# that is not finite), none
ENABLED = {'all': [True] * BATCH, 'some': [True, False, True, False, False, True],
           'none': [False] * BATCH}
# each game's QP step stretched, so that the games accept trials of different lengths
STRETCH = torch.tensor([1.0, 30.0, 3.0, 100.0, 10.0, 300.0], dtype=torch.float64)


# ------------------------------------------------ the selected-rows grids, kept
def selected_grid_v1(solver, enabled, u, du, l, dl, s, ds, phi0, dphi0, mu, x0, up, P=None):
    p = solver.params
    use_l1 = p.merit_function == 'stat_l1'
    W = p.line_search_iters
    alphas = torch.tensor(p.tau, dtype=solver.dtype, device=solver.device) ** \
        torch.arange(W, dtype=solver.dtype, device=solver.device)
    u_t, l_t, phi_out = u, l, phi0
    sel = torch.nonzero(enabled).flatten()
    nb = int(sel.numel())
    if nb == 0:
        return u_t, l_t, phi_out
    a3 = alphas[None, :, None]
    u_try = u[sel][:, None] + a3 * du[sel][:, None]
    l_try = l[sel][:, None] + a3 * dl[sel][:, None]
    s_try = s[sel][:, None] + a3 * ds[sel][:, None]
    rep = lambda v: v[sel][:, None].expand(nb, W, *v.shape[1:]).reshape(nb * W, *v.shape[1:])
    d_t, g_t = solver.problem.merit_terms(u_try.reshape(nb * W, -1),
                                          l_try.reshape(nb * W, -1), rep(x0), rep(up), P)
    phis = _merit_phi_dg(d_t, g_t, l_try.reshape(nb * W, -1), s_try.reshape(nb * W, -1),
                         rep(mu), use_l1).reshape(nb, W)
    ok = phis <= phi0[sel][:, None] + (p.beta * alphas)[None, :] * dphi0[sel][:, None]
    first = torch.argmax(ok.to(torch.uint8), dim=-1)
    idx = torch.where(ok.any(-1), first, W - 1)
    alpha_sel = alphas[idx][:, None]
    u_t = u.index_copy(0, sel, u[sel] + alpha_sel * du[sel])
    l_t = l.index_copy(0, sel, l[sel] + alpha_sel * dl[sel])
    phi_out = phi0.index_copy(0, sel, phis.gather(1, idx[:, None])[:, 0])
    return u_t, l_t, phi_out


def selected_grid_v2(solver, enabled, u, du, l, dl, s, mu, mem_max, x0, up, P, P_fn=None,
                     eval0=None, ck_ref=None):
    self = solver
    p = self.params
    use_l1 = p.merit_function in ('stat_l1', 'sum_obj_l1')
    sum_obj = p.merit_function == 'sum_obj_l1'
    sigma = p.merit_decrease

    if p.merit_decrease_condition == 'armijo':
        fresh = None
        if eval0 is not None and not sum_obj:
            Q0, q0, G0, g0, fresh = eval0
        else:
            Q0, q0, G0, g0 = self._eval_full(u, l, x0, up, P)
        obj0, dobj0 = None, None
        phi0 = self._phi(l, s, q0, G0, g0, mu, use_l1, obj=obj0)
        dphi0 = self._dphi(du, l, dl, torch.clamp(g0, min=0.0), Q0, q0, G0, g0, mu,
                           use_l1, dobj=dobj0)

        if fresh is not None and ck_ref is not None:
            phi0_ck, dphi0_ck = ck_ref

            def ref(alpha, sel):
                return torch.where(fresh[sel][:, None],
                                   phi0[sel][:, None] + sigma * alpha * dphi0[sel][:, None],
                                   phi0_ck[sel][:, None]
                                   + sigma * alpha * dphi0_ck[sel][:, None])
        elif fresh is not None:
            def ref(alpha, sel):
                return torch.where(fresh[sel][:, None],
                                   phi0[sel][:, None] + sigma * alpha * dphi0[sel][:, None],
                                   (1 - sigma * alpha) * mem_max[sel][:, None])
        else:
            def ref(alpha, sel):
                return phi0[sel][:, None] + sigma * alpha * dphi0[sel][:, None]
    else:  # 'max'
        def ref(alpha, sel):
            return (1 - sigma * alpha) * mem_max[sel][:, None]

    u_t, l_t = u, l
    phi1 = self._full(u.shape[0], math.inf)
    sel = torch.nonzero(enabled).flatten()
    nb = int(sel.numel())
    W = p.line_search_iters
    if nb == 0:
        return u_t, l_t, phi1
    alphas = torch.tensor(p.tau, dtype=self.dtype, device=self.device) ** \
        torch.arange(W, dtype=self.dtype, device=self.device)
    a3 = alphas[None, :, None]
    u_try = (u[sel][:, None] + a3 * du[sel][:, None]).reshape(nb * W, -1)
    l_try = (l[sel][:, None] + a3 * dl[sel][:, None]).reshape(nb * W, -1)
    rep = lambda v: v[sel].repeat_interleave(W, dim=0)
    x0_r, up_r = rep(x0), rep(up)
    if P_fn is not None:
        P_t = P_fn(u_try, x0_r)
    elif self._approx_update is not None:
        P_t = _rows(P, sel, W)
    else:
        P_t = P
    d_t, g_t = self.problem.merit_terms(u_try, l_try, x0_r, up_r, P_t)
    s_t = torch.clamp(g_t, min=0.0)
    phis = self._phi_d(d_t, s_t, rep(mu), use_l1).reshape(nb, W)
    phi1s = self._phi_d(d_t, s_t, 1.0, use_l1).reshape(nb, W)
    ok = phis <= ref(alphas[None, :], sel)
    first = torch.argmax(ok.to(torch.uint8), dim=-1)
    idx = torch.where(ok.any(-1), first, W - 1)
    alpha_sel = alphas[idx][:, None]
    u_t = u.index_copy(0, sel, u[sel] + alpha_sel * du[sel])
    l_t = l.index_copy(0, sel, l[sel] + alpha_sel * dl[sel])
    phi1 = phi1.index_copy(0, sel, phi1s.gather(1, idx[:, None])[:, 0])
    return u_t, l_t, phi1


# --------------------------------------------------------------------- inputs
@pytest.fixture(scope='module')
def v1():
    """The bench chicane's v1 solver (N = 5, float64) and a grid's inputs at its batch:
    the QP step of the warm start, its slack, merit penalty, merit and slope."""
    sc, solver = build_bench_solver(horizon=N, solver_name='v1', dtype=torch.float64,
                                    device='cpu')
    u, l, x0, up = build_bench_batch(sc, solver, BATCH, seed=0)
    Q, q, G, g, _ = solver._eval_full(u, l, x0, up)
    du, lhat, fin, _ = solver._qp(Q, q, G, g)
    assert bool(fin.all())
    du, dl = STRETCH[:, None] * du, STRETCH[:, None] * (lhat - l)
    s = torch.clamp(g, max=0.0)
    ds = g + (G @ du[..., None])[..., 0] - s
    mu = _get_mu(du, l, dl, s, Q, q, G, g, solver.params.merit_function)
    use_l1 = solver.params.merit_function == 'stat_l1'
    # game 3's reference lowered below any trial's merit: it takes the last trial
    phi0 = _merit_phi(l, s, q, G, g, mu, use_l1) * torch.tensor([1, 1, 1, 1e-3, 1, 1])
    dphi0 = _merit_dphi(du, l, dl, s, Q, q, G, g, mu, use_l1)
    return solver, [u, du, l, dl, s, ds, phi0, dphi0, mu, x0, up]


def _v2_inputs(sc, solver, B):
    """A v2 line search's inputs (after ``enabled``) at a batch of B, from its warm start:
    the round's derivatives and QP step, and made-up merit memory, freshness and
    checkpoint references that put the games on both sides of each test."""
    u, l, x0, up = build_bench_batch(sc, solver, B, seed=0)
    P = solver._approx_update(u, x0) if solver._approx_update is not None else None
    Q, q, G, g = solver._eval_full(u, l, x0, up, P)
    du, lhat, ok = solver._qp(Q, q, G, g, solver._full(B, solver.params.reg))
    assert bool(ok.all())
    du, dl = STRETCH[:B, None] * du, STRETCH[:B, None] * (lhat - l)
    s = torch.clamp(g, min=0.0)
    mu = solver._get_mu(du, l, dl, s, Q, q, G, g)
    phi = solver._phi(l, s, q, G, g, mu, True)
    dphi = solver._dphi(du, l, dl, s, Q, q, G, g, mu, True)
    # games 1 and 4 are stale; the memory's and the checkpoint's references of game 1
    # lie below any trial's merit
    scale = torch.tensor([0.8, 1e-3, 1.0, 1.2, 0.9, 1.5], dtype=u.dtype)[:B]
    fresh = torch.arange(B) % 3 != 1
    return dict(u=u, du=du, l=l, dl=dl, s=s, mu=mu, mem_max=phi * scale, x0=x0, up=up,
                P=P, eval0=(Q, q, G, g, fresh), ck_ref=(phi * scale, dphi))


@pytest.fixture(scope='module')
def v2():
    sc, solver = build_bench_solver(horizon=N, solver_name='v2', dtype=torch.float64,
                                    device='cpu')
    return solver, _v2_inputs(sc, solver, BATCH)


def _enabled(case, B=BATCH):
    return torch.tensor(ENABLED[case][:B])


def _poisoned(enabled, *steps):
    """The steps, with a disabled game's rows made not finite."""
    off = torch.nonzero(~enabled).flatten()
    out = []
    for st in steps:
        st = st.clone()
        st[off[:1]] = math.nan
        out.append(st)
    return out


def _close(got, want):
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(torch.isinf(a), torch.isinf(b))
        fin = torch.isfinite(b)
        assert torch.allclose(a[fin], b[fin], rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------- tests
@pytest.mark.parametrize('case', sorted(ENABLED))
def test_v1_full_width_grid_matches_the_selected_rows_grid(v1, case):
    solver, args = v1
    enabled = _enabled(case)
    want = selected_grid_v1(solver, enabled, *args)
    u, du, l, dl, s, ds, *rest = args
    du_p, dl_p, ds_p = _poisoned(enabled, du, dl, ds)
    got = solver._grid_ls(enabled, u, du_p, l, dl_p, s, ds_p, *rest)
    _close(got, want)
    off = ~enabled
    assert all(torch.equal(a[off], b[off]) for a, b in zip(got, (u, l, args[6])))


REFS = {
    # name: (merit_decrease_condition, eval0 passed, ck_ref passed)
    'armijo_checkpoint': ('armijo', True, True),
    'armijo_memory': ('armijo', True, False),
    'armijo': ('armijo', False, False),
    'max': ('max', True, True),
}


@pytest.mark.parametrize('case', sorted(ENABLED))
@pytest.mark.parametrize('ref', sorted(REFS))
def test_v2_full_width_grid_matches_the_selected_rows_grid(v2, ref, case, monkeypatch):
    solver, inp = v2
    cond, with_eval0, with_ck = REFS[ref]
    monkeypatch.setattr(solver.params, 'merit_decrease_condition', cond)
    enabled = _enabled(case)
    kw = dict(eval0=inp['eval0'] if with_eval0 else None,
              ck_ref=inp['ck_ref'] if with_ck else None)
    pos = [inp[k] for k in ('u', 'du', 'l', 'dl', 's', 'mu', 'mem_max', 'x0', 'up', 'P')]
    want = selected_grid_v2(solver, enabled, *pos, **kw)
    du_p, dl_p = _poisoned(enabled, inp['du'], inp['dl'])
    pos[1], pos[3] = du_p, dl_p
    got = solver._line_search(enabled, *pos, **kw)
    _close(got, want)
    off = ~enabled
    assert torch.equal(got[0][off], inp['u'][off]) and torch.equal(got[1][off], inp['l'][off])
    assert torch.equal(torch.isinf(got[2]), off)


@pytest.mark.parametrize('mode', ['once', 'always'])
def test_v2_full_width_grid_of_the_approximate_game(mode, monkeypatch):
    """The approximate duel (N = 6, 4 games): the parameters repeated for each trial
    (``'once'``), or re-linearized at each trial point (``'always'``)."""
    monkeypatch.setenv('DGSQP_BENCH_EVAL', mode)
    sc, solver = build_bench_solver(horizon=6, solver_name='approx', dtype=torch.float64,
                                    device='cpu')
    B = 4
    inp = _v2_inputs(sc, solver, B)
    enabled = _enabled('some', B)
    pos = [inp[k] for k in ('u', 'du', 'l', 'dl', 's', 'mu', 'mem_max', 'x0', 'up', 'P')]
    always = mode == 'always'
    kw = dict(eval0=inp['eval0'], ck_ref=inp['ck_ref'])
    want = selected_grid_v2(solver, enabled, *pos,
                            P_fn=solver._approx_update if always else None, **kw)
    got = solver._line_search(enabled, *pos, relinearize=always, **kw)
    _close(got, want)


@pytest.mark.parametrize('name', ['v1', 'v2'])
def test_grid_counters_on_the_cpu(v1, v2, name):
    """Traced, a grid reads the enabled count once (``merit.games``) and nothing else,
    counts ``merit_points`` at the batch's full width and runs eagerly
    (``merits.graph.eager``); untraced it records nothing."""
    solver, inp = v1 if name == 'v1' else v2
    enabled = _enabled('some')
    if name == 'v1':
        call = lambda: solver._grid_ls(enabled, *inp)
    else:
        pos = [inp[k] for k in ('u', 'du', 'l', 'dl', 's', 'mu', 'mem_max', 'x0', 'up', 'P')]
        call = lambda: solver._line_search(enabled, *pos, eval0=inp['eval0'],
                                           ck_ref=inp['ck_ref'])
    profiling.disable()
    profiling.reset()
    off = call()
    assert profiling.snapshot() == dict(spans=[], counters={})
    try:
        with profiling.tracing():
            on = [call() for _ in range(2)]
        c = profiling.snapshot()['counters'][0]
    finally:
        profiling.reset()
    assert all(torch.equal(a, b) for o in on for a, b in zip(o, off))
    W = solver.params.line_search_iters
    assert c == {'merit_games': 2 * sum(ENABLED['some']), 'merit_points': 2 * BATCH * W,
                 'merits.graph.eager': 2, 'host_syncs': 2, 'host_syncs.merit.games': 2}
    assert solver._merit_graphs._entries == {}
