"""The plain replay of one round of DGSQP v2 (the journal algorithm with non-monotone
globalization: cheap d-steps under a shrinking trust quantity, m-steps that check the
full step against the merit memory, watchdog rollback to the checkpoint and an Armijo
line search from there), for the check that decides ``correct``.

Given the program's state before the round (its carry, field by field) and the round's
QP answer (step, duals, success), the reference evaluates the game itself in float64
and works out the state after the round.  Written for the ``stat_l1`` merit with the
Armijo condition, the configurations the benchmark runs.  It imports nothing of the
program.
"""
from __future__ import annotations

import math

import torch

import perf_ref
from perf_ref import dot, mtv, mv, sel

HOOK = '_make_body'    # the solver's method that makes the round
EXACT = ('status', 'it', 'm_it', 'rel_its', 'ck_counter', 'ck_valid', 'ck_fresh',
         'mem_ptr')
CLOSE = ('u', 'l', 'delta', 'reg')

RUNNING, CONV_ABS, CONV_REL, DIVERGED, QP_FAIL, MAX_IT, TIME_LIMIT, STALLED = range(8)
REL_TOL_REQ = 10


def replay(game, p: dict, floor: float, c: dict, x0, up, qp: dict) -> dict:
    """The carry after one round, from the carry ``c`` before it and the QP answer
    ``qp`` (``du``, ``lam``, ``ok``)."""
    if p['merit_function'] != 'stat_l1' or p['merit_decrease_condition'] != 'armijo':
        raise NotImplementedError('the replay covers the stat_l1 merit with Armijo')
    xtol, ltol, sigma = p['p_tol'], p['d_tol'], p['merit_decrease']
    running = c['status'] == RUNNING
    u, l = c['u'], c['l']
    false = torch.zeros_like(running)

    _, q, G, g = perf_ref.evaluate(game, u, l, x0, up, hessian=False)
    F = q + mtv(G, l)
    p_feas = torch.clamp(g.amax(-1), min=0.0)
    comp = (g * l).abs().amax(-1)
    stat = F.abs().amax(-1)
    diverged = stat > 1e10
    scale = torch.clamp(q.abs().amax(-1), min=1.0) if p['conv_scaled_stat'] \
        else torch.ones_like(stat)
    converged = (p_feas < xtol) & (comp < ltol * scale) & (stat < ltol * scale)
    max_it = c['m_it'] >= p['sqp_iters']
    keep_going = running & ~(diverged | converged | max_it)

    du, lhat, qp_ok = qp['du'], qp['lam'], qp['ok']
    dl = lhat - l
    step_norm = torch.linalg.vector_norm(torch.cat([du, dl], -1), dim=-1)
    first = c['it'] == 0
    delta = torch.where(first, max(0.0, float(p['nms_initial_step_size_factor'])) * step_norm,
                        c['delta'])
    ck_delta = torch.where(first, delta, c['ck_delta'])
    s = torch.clamp(g, min=0.0)
    # the QP gets the symmetrised game Hessian
    Qdu = 0.5 * (perf_ref.hessian_times(game, u, l, x0, up, du)
                 + perf_ref.hessian_times(game, u, l, x0, up, du, transpose=True))

    def dphi(mu):
        return dot(F, Qdu + mtv(G, dl)) - mu * s.sum(-1)

    if p['merit_parameter'] is not None:
        mu = torch.full_like(stat, float(p['merit_parameter']))
    else:
        vio = s.sum(-1)
        mu = torch.where(vio > floor * (1.0 + g.abs().amax(-1)),
                         dphi(0.0).abs() / (0.5 * torch.clamp(vio, min=1e-300)), 0.0)

    # the checkpoint made last round commits with this round's step
    refresh = c['ck_fresh'] & keep_going & qp_ok
    ck = {k: sel(refresh, v, c['ck_' + k]) for k, v in
          (('u', u), ('l', l), ('du', du), ('dl', dl), ('s', s))}
    ck['mu'] = torch.where(refresh, mu, c['ck_mu'])
    ck['delta'] = torch.where(refresh, delta, ck_delta)
    ck['reg'] = torch.where(refresh, c['reg'], c['ck_reg'])
    phi0 = 0.5 * dot(F, F) + mu * s.sum(-1)
    dphi0 = dphi(mu)
    ck['phi0'] = torch.where(refresh, phi0, c['ck_phi0'])
    ck['dphi0'] = torch.where(refresh, dphi0, c['ck_dphi0'])
    ck_valid = c['ck_valid'] | refresh

    if p['nms']:
        recover = ~qp_ok & ck_valid
        m_step = recover | (qp_ok & ((c['ck_counter'] >= p['nms_frequency'])
                                     | (step_norm >= delta)))
        d_step = qp_ok & ~m_step
        plain_ls = false
        hard_qp_fail = ~qp_ok & ~ck_valid
    else:
        recover = m_step = d_step = false
        plain_ls = qp_ok
        hard_qp_fail = ~qp_ok

    src = {k: sel(recover, ck[k], v) for k, v in
           (('u', u), ('l', l), ('du', du), ('dl', dl), ('s', s))}
    src_mu = torch.where(recover, ck['mu'], mu)
    u_full, l_full = src['u'] + src['du'], src['l'] + src['dl']
    phi_full = torch.full_like(stat, math.inf)
    idx = torch.nonzero(m_step & keep_going).flatten()
    if idx.numel():
        d_f, g_f = perf_ref.merit_terms(game, u_full[idx], l_full[idx], x0[idx], up[idx])
        phi_full = phi_full.index_copy(
            0, idx, 0.5 * dot(d_f, d_f) + torch.clamp(g_f, min=0.0).sum(-1))
    accept_full = m_step & (phi_full <= (1 - sigma) * c['memory'].amax(-1))

    rollback = m_step & ~accept_full & ck_valid
    ls = {k: sel(rollback, ck[k], src[k]) for k in ('u', 'l', 'du', 'dl')}
    ls_mu = torch.where(rollback, ck['mu'], src_mu)
    delta = torch.where(rollback, ck['delta'], delta)
    reg = torch.where(rollback, ck['reg'], c['reg'])
    ls_en = (m_step & ~accept_full) | plain_ls
    fresh = ~(rollback | recover)
    u_ls, l_ls, phi_ls = line_search(game, p, ls_en & keep_going, ls, ls_mu, fresh,
                                     phi0, dphi0, ck['phi0'], ck['dphi0'], x0, up)

    u_n = sel(d_step, u + du, sel(accept_full, u_full, sel(ls_en, u_ls, u)))
    l_n = sel(d_step, l + dl, sel(accept_full, l_full, sel(ls_en, l_ls, l)))
    u_n, l_n = sel(keep_going, u_n, u), sel(keep_going, l_n, l)

    mstep_done = keep_going & (m_step | plain_ls)
    phi_new = torch.where(accept_full, phi_full, phi_ls)
    delta = torch.where(keep_going & d_step, p['delta_decay'] * delta, delta)
    ck_counter = torch.where(keep_going & d_step, c['ck_counter'] + 1,
                             torch.where(mstep_done, 0, c['ck_counter']))
    reg = torch.where(mstep_done, reg * c['reg_decay'], reg)
    ptr = (c['mem_ptr'] + 1) % int(p['nms_memory_size'])
    memory = sel(mstep_done, c['memory'].scatter(1, ptr[:, None], phi_new[:, None]),
                 c['memory'])
    mem_ptr = torch.where(mstep_done, ptr, c['mem_ptr'])
    ck_fresh = torch.where(keep_going, mstep_done, c['ck_fresh'])

    small = (torch.linalg.vector_norm(u_n - c['u_im1'], dim=-1) < xtol) & \
            (torch.linalg.vector_norm(l_n - c['l_im1'], dim=-1) < ltol)
    rel_its = torch.where(mstep_done & small, c['rel_its'] + 1,
                          torch.where(mstep_done, 0, c['rel_its']))
    conv_rel = mstep_done & (rel_its >= REL_TOL_REQ) & (p_feas < xtol)
    m_it = c['m_it'] + mstep_done.to(c['m_it'].dtype)
    it = c['it'] + keep_going.to(c['it'].dtype)
    improved = stat < 0.99 * c['stat_best']
    stall = torch.where(keep_going, torch.where(improved, 0, c['stall'] + 1), c['stall'])
    is_stalled = stall >= p['stall_its'] if p['stall_its'] is not None else false

    status = torch.full_like(c['status'], RUNNING)
    for cond, code in ((is_stalled, STALLED), (conv_rel, CONV_REL), (hard_qp_fail, QP_FAIL),
                       (max_it, MAX_IT), (diverged, DIVERGED), (converged, CONV_ABS)):
        status = torch.where(cond, code, status)

    new = dict(u=u_n, l=l_n, it=it, m_it=m_it, rel_its=rel_its, ck_counter=ck_counter,
               ck_valid=ck_valid, ck_fresh=ck_fresh, mem_ptr=mem_ptr, delta=delta, reg=reg)
    # a game that does not go on keeps its state; one that ends here records its status
    out = {k: sel(keep_going, v, c[k]) for k, v in new.items()}
    out['status'] = sel(running, status, c['status'])
    return out


def line_search(game, p, enabled, ls, mu, fresh, phi0, dphi0, ck_phi0, ck_dphi0, x0, up):
    """Armijo on the trial grid alpha = tau^j from the round's own point (``fresh``,
    against its merit and slope) or from the checkpoint (against the checkpoint's);
    the first trial accepted, else the last.  Returns (u, l, the accepted trial's merit
    at mu = 1); games not ``enabled`` keep (u, l, inf)."""
    u, l, du, dl = ls['u'], ls['l'], ls['du'], ls['dl']
    inf = torch.full_like(mu, math.inf)
    idx = torch.nonzero(enabled).flatten()
    nb = int(idx.numel())
    if nb == 0:
        return u, l, inf
    W = int(p['line_search_iters'])
    sigma = p['merit_decrease']
    alphas = torch.tensor(p['tau'], dtype=u.dtype, device=u.device) ** \
        torch.arange(W, dtype=u.dtype, device=u.device)
    a = alphas[None, :, None]
    u_t = (u[idx][:, None] + a * du[idx][:, None]).reshape(nb * W, -1)
    l_t = (l[idx][:, None] + a * dl[idx][:, None]).reshape(nb * W, -1)
    rep = lambda v: v[idx].repeat_interleave(W, dim=0)
    d_t, g_t = perf_ref.merit_terms(game, u_t, l_t, rep(x0), rep(up))
    half, viol = 0.5 * dot(d_t, d_t), torch.clamp(g_t, min=0.0).sum(-1)
    phis = (half + rep(mu) * viol).reshape(nb, W)
    phi1s = (half + viol).reshape(nb, W)
    f = fresh[idx][:, None]
    ref = torch.where(f, phi0[idx][:, None] + sigma * alphas[None, :] * dphi0[idx][:, None],
                      ck_phi0[idx][:, None] + sigma * alphas[None, :] * ck_dphi0[idx][:, None])
    ok = phis <= ref
    j = torch.where(ok.any(-1), torch.argmax(ok.to(torch.uint8), dim=-1), W - 1)
    step = alphas[j][:, None]
    return (u.index_copy(0, idx, u[idx] + step * du[idx]),
            l.index_copy(0, idx, l[idx] + step * dl[idx]),
            inf.index_copy(0, idx, phi1s.gather(1, j[:, None])[:, 0]))
