"""The plain replay of one round of DGSQP v1's flat round machine (the SQP step with its
non-monotone watchdog: the full step, the A/B merit check, two insurance rounds and the
fallback line search), for the check that decides ``correct``.

Given the program's state before the round (its carry, field by field) and the round's
QP answer (step, duals, finite), the reference evaluates the game itself in float64 and
works out the state after the round: the merit and its slope, the grid line search, the
acceptance decisions, the status cascade and the counters.  It imports nothing of the
program.
"""
from __future__ import annotations

import torch

import perf_ref
from perf_ref import dot, mtv, mv, sel

HOOK = '_round'        # the solver's method that runs one round
# fields compared after the round: exactly, and to a relative tolerance
EXACT = ('status', 'it', 'mode', 't', 'rel_its', 'qp_solves', 'stall')
CLOSE = ('u', 'l', 'u_cur', 'l_cur')

RUNNING, CONV_ABS, CONV_REL, DIVERGED, QP_FAIL, MAX_IT, TIME_LIMIT, STALLED = range(8)
FM_STEP, FM_AB, FM_INS2, FM_INS3, FM_FB = range(5)
T_HAT, MERIT_MAX, REL_TOL_REQ = 5, 1e6, 3


def replay(game, p: dict, floor: float, c: dict, x0, up, qp: dict) -> dict:
    """The carry after one round, from the carry ``c`` before it and the QP answer
    ``qp`` (``du``, ``lam``, ``ok``); ``floor`` is the merit penalty's feasibility noise
    floor of the configured dtype."""
    xtol, ltol, beta = p['p_tol'], p['d_tol'], p['beta']
    use_l1 = p['merit_function'] == 'stat_l1'
    running = c['status'] == RUNNING
    mode = c['mode']
    is_step, is_ab, is_2, is_3, is_fb = (mode == m for m in range(5))

    u_e = sel(is_step, c['u'], c['u_cur'])
    l_e = sel(is_step, c['l'], c['l_cur'])
    _, q, G, g = perf_ref.evaluate(game, u_e, l_e, x0, up, hessian=False)
    d = q + mtv(G, l_e)
    p_feas = torch.clamp(g.amax(-1), min=0.0)
    comp = (g * l_e).abs().amax(-1)
    stat = d.abs().amax(-1)

    du, lhat, fin = qp['du'], qp['lam'], qp['ok']
    dl = lhat - l_e
    s = torch.clamp(g, max=0.0)
    Gdu = mv(G, du)
    ds = g + Gdu - s
    Qdu = perf_ref.hessian_times(game, u_e, l_e, x0, up, du)
    lg = dot(l_e, g)

    def phi(s_, mu):
        val = 0.5 * (dot(d, d) + lg ** 2)
        return val + mu * torch.sum(g - s_, -1) if use_l1 else val

    def dphi(mu):
        val = dot(d, Qdu + mtv(G, dl)) + lg * (dot(l_e, Gdu) + dot(dl, g))
        return val - mu * torch.sum(g - s, -1) if use_l1 else val

    if p['merit_function'] == 'stat':
        mu_t = torch.zeros_like(stat)
    else:
        vio = torch.sum(g - s, -1)
        mu_pos = dphi(0.0).abs() / (0.5 * torch.clamp(vio, min=1e-300))
        mu_t = torch.where(vio > floor * (1.0 + g.abs().amax(-1)), mu_pos, 0.0)
    phi_t, dphi_t = phi(s, mu_t), dphi(mu_t)
    phi_cur = phi(c['s_pred'], c['mu'])
    phi0_23, dphi0_23 = phi(s, c['mu']), dphi(c['mu'])

    # the grid line search: the insurance rounds along this round's step, the fallback
    # along the iteration's own
    ls_en = (((is_2 | is_3) & fin) | is_fb) & running
    b_u, b_du = sel(is_fb, c['u_k'], u_e), sel(is_fb, c['du_k'], du)
    b_l, b_dl = sel(is_fb, c['l_k'], l_e), sel(is_fb, c['dl_k'], dl)
    b_s, b_ds = sel(is_fb, c['s_k'], s), sel(is_fb, c['ds_k'], ds)
    b_phi0 = torch.where(is_fb, c['phi_k'], phi0_23)
    b_dphi0 = torch.where(is_fb, c['dphi_k'], dphi0_23)
    u_ls, l_ls, phi_ls = line_search(game, p, ls_en, b_u, b_du, b_l, b_dl, b_s, b_ds,
                                     b_phi0, b_dphi0, c['mu'], x0, up, use_l1)

    accept_ref = c['phi_k'] + beta * c['dphi_k']
    over_max = is_ab & (phi_cur > MERIT_MAX) & (c['t'] > 1)
    accepted = is_ab & (phi_cur <= accept_ref) & ~over_max
    exhausted = is_ab & ~accepted & ~over_max & (c['t'] >= T_HAT + 1)
    cont = is_ab & ~accepted & ~over_max & ~exhausted
    m2_fail = is_2 & ~fin
    m2_acc = is_2 & fin & (phi_ls <= accept_ref)
    m2_worse = is_2 & fin & (phi_ls > c['phi_k']) & ~m2_acc
    m2_cont = is_2 & fin & ~m2_acc & ~m2_worse
    m3_fail = is_3 & ~fin
    m3_done = is_3 & fin

    complete = accepted | m2_acc | m3_done | is_fb
    via_ls = m2_acc | m3_done | is_fb
    u_new = sel(accepted, u_e, sel(via_ls, u_ls, c['u']))
    l_new = sel(accepted, l_e, sel(via_ls, l_ls, c['l']))
    small = (torch.linalg.vector_norm(u_new - c['u'], dim=-1) < xtol / 2) & \
            (torch.linalg.vector_norm(l_new - c['l'], dim=-1) < ltol / 2)
    rel_its = torch.where(complete, torch.where(small, c['rel_its'] + 1, 0), c['rel_its'])
    conv_rel = complete & (rel_its >= REL_TOL_REQ) & (c['p_feas'] < xtol)
    it = c['it'] + complete.to(c['it'].dtype)

    # the status cascade
    status = c['status']
    diverged = stat > 1e5
    converged = (p_feas < xtol) & (comp < ltol) & (stat < ltol)
    step_term = is_step & (converged | diverged)
    status = torch.where(is_step & converged, CONV_ABS, status)
    status = torch.where(is_step & diverged & ~converged, DIVERGED, status)
    step_qp_fail = is_step & ~step_term & ~fin
    status = torch.where(step_qp_fail, QP_FAIL, status)
    step_go = is_step & ~step_term & ~step_qp_fail
    over_it = it >= p['sqp_iters']
    status = torch.where(complete & conv_rel, CONV_REL, status)
    status = torch.where(complete & ~conv_rel & over_it, MAX_IT, status)
    acc_go0 = accepted & ~conv_rel & ~over_it
    status = torch.where(acc_go0 & converged, CONV_ABS, status)
    status = torch.where(acc_go0 & diverged & ~converged, DIVERGED, status)
    acc_body = acc_go0 & ~converged & ~diverged
    status = torch.where(acc_body & ~fin, QP_FAIL, status)
    acc_go = acc_body & fin

    qp_inc = (is_step & ~step_term) | acc_body | cont | is_2 | is_3
    qp_solves = c['qp_solves'] + qp_inc.to(c['qp_solves'].dtype)
    if p['qp_solves_limit'] is not None:
        over_budget = complete & (status == RUNNING) & (qp_solves >= p['qp_solves_limit'])
        status = torch.where(over_budget, TIME_LIMIT, status)
    upd_stall = is_step | accepted
    improved = stat < 0.99 * c['stat_best']
    stall = torch.where(upd_stall, torch.where(improved, 0, c['stall'] + 1), c['stall'])
    if p['stall_its'] is not None:
        status = torch.where((status == RUNNING) & (stall >= p['stall_its']), STALLED, status)

    # the watchdog's next mode and candidate
    form = step_go | acc_go
    advance = form | (cont & fin)
    u_cur = sel(advance, u_e + du, sel(over_max, c['u_prev'], sel(m2_cont, u_ls, c['u_cur'])))
    l_cur = sel(advance, lhat, sel(over_max, c['l_prev'], sel(m2_cont, l_ls, c['l_cur'])))
    t = torch.where(form, 1, torch.where(cont & fin, c['t'] + 1, c['t']))
    mode = torch.where(form, FM_AB, mode)
    mode = torch.where(cont & ~fin, FM_FB, mode)
    mode = torch.where(over_max | exhausted, FM_INS2, mode)
    mode = torch.where(m2_fail | m2_worse | m3_fail, FM_FB, mode)
    mode = torch.where(m2_cont, FM_INS3, mode)
    mode = torch.where(via_ls, FM_STEP, mode)

    new = dict(u=sel(complete, u_new, c['u']), l=sel(complete, l_new, c['l']), it=it,
               status=status, rel_its=rel_its, qp_solves=qp_solves, mode=mode, t=t,
               u_cur=u_cur, l_cur=l_cur, stall=stall)
    # a game that is no longer running keeps its state
    return {k: sel(running, v, c[k]) for k, v in new.items()}


def line_search(game, p, enabled, u, du, l, dl, s, ds, phi0, dphi0, mu, x0, up, use_l1):
    """Armijo on the trial grid alpha = tau^j, j < line_search_iters: the first trial
    accepted, else the last; games not ``enabled`` keep (u, l, phi0)."""
    W = int(p['line_search_iters'])
    alphas = torch.tensor(p['tau'], dtype=u.dtype, device=u.device) ** \
        torch.arange(W, dtype=u.dtype, device=u.device)
    idx = torch.nonzero(enabled).flatten()
    nb = int(idx.numel())
    if nb == 0:
        return u, l, phi0
    a = alphas[None, :, None]
    u_t = (u[idx][:, None] + a * du[idx][:, None]).reshape(nb * W, -1)
    l_t = (l[idx][:, None] + a * dl[idx][:, None]).reshape(nb * W, -1)
    s_t = (s[idx][:, None] + a * ds[idx][:, None]).reshape(nb * W, -1)
    rep = lambda v: v[idx].repeat_interleave(W, dim=0)
    d_t, g_t = perf_ref.merit_terms(game, u_t, l_t, rep(x0), rep(up))
    phis = 0.5 * (dot(d_t, d_t) + dot(l_t, g_t) ** 2)
    if use_l1:
        phis = phis + rep(mu) * torch.sum(g_t - s_t, -1)
    phis = phis.reshape(nb, W)
    ok = phis <= phi0[idx][:, None] + (p['beta'] * alphas)[None, :] * dphi0[idx][:, None]
    j = torch.where(ok.any(-1), torch.argmax(ok.to(torch.uint8), dim=-1), W - 1)
    step = alphas[j][:, None]
    return (u.index_copy(0, idx, u[idx] + step * du[idx]),
            l.index_copy(0, idx, l[idx] + step * dl[idx]),
            phi0.index_copy(0, idx, phis.gather(1, j[:, None])[:, 0]))
