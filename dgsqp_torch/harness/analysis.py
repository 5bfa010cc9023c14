"""Result aggregation and cross-solver comparison, the port's own copy of
``dgsqp_tpu/harness/analysis.py`` (numpy only):

  * :func:`summarize`: convergence percentages, diverged/max-iteration counts, QP-solve
    counts, solve-time statistics, terminal feasibility violations of one study;
  * :func:`success_locations`: (s, e_y, converged) of the ego initial conditions;
  * :func:`gne_compare`: whether two solvers (or two formulations) agree on the game's
    equilibrium on the same sampled instances.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from dgsqp_torch.harness.mc_study import MCResults
from dgsqp_torch.solvers.dgsqp import CONV_ABS, CONV_REL, DIVERGED, MAX_IT, QP_FAIL


def summarize(results: MCResults) -> Dict:
    """Per-config summary table row."""
    st = results.statuses
    conv = np.isin(st, (CONV_ABS, CONV_REL))
    return dict(
        scenario=results.scenario,
        solver=results.solver,
        total=int(results.num_samples),
        conv_pct=100.0 * conv.mean() if len(st) else 0.0,
        diverged=int((st == DIVERGED).sum()),
        qp_fail=int((st == QP_FAIL).sum()),
        max_iter=int((st == MAX_IT).sum()),
        mean_sqp_iters=float(results.iters[conv].mean()) if conv.any() else float('nan'),
        mean_qp_solves=float(results.qp_solves[conv].mean()) if conv.any() else float('nan'),
        solve_time_mean_s=results.wall_time_s / max(results.num_samples, 1),
        feas_vio_mean=float(results.p_feas[~conv].mean()) if (~conv).any() else 0.0,
        feas_vio_max=float(results.p_feas.max()) if len(st) else 0.0,
    )


def success_locations(results: MCResults, ego_s_idx: int = 4, ego_ey_idx: int = 5):
    """(s, e_y, converged) triples of the ego initial conditions: the data behind a
    success-location scatter on the track map."""
    conv = np.isin(results.statuses, (CONV_ABS, CONV_REL))
    return np.stack([results.x0[:, ego_s_idx], results.x0[:, ego_ey_idx],
                     conv.astype(float)], axis=-1)


def stage_inputs(u_sol: np.ndarray, N: int, num_ua, layout: str = 'agent_flat'):
    """Per-sample input sequences as (B, N, n_u) stage matrices.

    ``layout='agent_flat'`` is the DGSQP family's agent-stacked flat vector; ``'stage'``
    is the (N, n_u) order.
    """
    u_sol = np.asarray(u_sol)
    B = u_sol.shape[0]
    if layout == 'stage':
        return u_sol.reshape(B, N, -1)
    parts, off = [], 0
    for na in num_ua:
        parts.append(u_sol[:, off:off + N * na].reshape(B, N, na))
        off += N * na
    return np.concatenate(parts, axis=2)


def gne_compare(results_a: MCResults, results_b: MCResults, N: int, num_ua,
                layout_a: str = 'agent_flat', layout_b: str = 'agent_flat',
                input_scale=None, match_tol: float = 0.1,
                keep_cols_a=None, keep_cols_b=None, num_ua_b=None,
                rollout_fn=None, x0=None, success: str = 'abs',
                hist_max: float = 0.3, hist_bins: int = 12) -> Dict:
    """Equilibrium agreement between two solvers on the same sampled instances:

      * per-sample normalized MSE between input sequences, normalized by the input
        bounds and horizon (``||(u_a - u_b)/scale||_F / N``);
      * min/mean/median/max and a histogram of that distribution;
      * the equilibrium-match rate at ``match_tol``;
      * disagreement localization: the per-stage input-gap profile, the first stage
        where the gap exceeds the tolerance, and (with ``rollout_fn``) the largest
        trajectory deviation per sample;
      * ``keep_cols_*`` selects shared input channels when the two formulations have
        different inputs.

    ``success='abs'`` counts only ``conv_abs_tol`` as converged; ``'any'`` also counts
    ``conv_rel_tol``.
    """
    if results_a.num_samples != results_b.num_samples:
        raise ValueError('the two studies hold different numbers of samples')
    ok_codes = (CONV_ABS,) if success == 'abs' else (CONV_ABS, CONV_REL)
    conv_a = np.isin(results_a.statuses, ok_codes)
    conv_b = np.isin(results_b.statuses, ok_codes)
    both = conv_a & conv_b

    ua = stage_inputs(results_a.u_sol, N, num_ua, layout_a)
    ub = stage_inputs(results_b.u_sol, N, num_ua_b or num_ua, layout_b)
    if keep_cols_a is not None:
        ua = ua[:, :, keep_cols_a]
    if keep_cols_b is not None:
        ub = ub[:, :, keep_cols_b]
    if ua.shape != ub.shape:
        raise ValueError(f'input sequences differ in shape: {ua.shape} and {ub.shape}')
    if input_scale is None:
        input_scale = np.ones(ua.shape[-1])
    diff = (ua - ub) / np.asarray(input_scale)[None, None, :]

    nmse = np.linalg.norm(diff.reshape(diff.shape[0], -1), axis=1) / N
    d = nmse[both]
    match = both & (nmse <= match_tol)

    # disagreement localization
    stage_gap = np.abs(diff).max(axis=2)                    # (B, N)
    over = stage_gap > match_tol
    first_bad = np.where(over.any(axis=1), over.argmax(axis=1), -1)

    out = dict(
        total=int(results_a.num_samples),
        converged_a=int(conv_a.sum()), converged_b=int(conv_b.sum()),
        both_converged=int(both.sum()),
        match=int(match.sum()),
        match_rate_of_both=float(match.sum() / both.sum()) if both.any() else 0.0,
        match_rate_of_total=float(match.mean()),
        match_tol=float(match_tol),
        nmse_min=float(d.min()) if d.size else None,
        nmse_mean=float(d.mean()) if d.size else None,
        nmse_median=float(np.median(d)) if d.size else None,
        nmse_max=float(d.max()) if d.size else None,
        # overflow bucket: disagreements beyond hist_max land in the last bin
        nmse_hist=np.histogram(np.minimum(d, hist_max),
                               bins=np.linspace(0, hist_max, hist_bins + 1))[0]
            .tolist() if d.size else None,
        stage_gap_profile_p50=np.median(stage_gap[both], axis=0).tolist()
            if both.any() else None,
        first_disagreement_stage={int(i): int(s) for i, s in enumerate(first_bad)
                                  if both[i] and s >= 0},
    )

    if rollout_fn is not None and x0 is not None and both.any():
        xy_gaps = []
        for i in np.where(both)[0]:
            xa = np.asarray(rollout_fn(ua[i], np.asarray(x0[i])))
            xb = np.asarray(rollout_fn(ub[i], np.asarray(x0[i])))
            xy_gaps.append(float(np.abs(xa - xb).max()))
        xy_gaps = np.asarray(xy_gaps)
        out.update(traj_gap_p50=float(np.median(xy_gaps)),
                   traj_gap_max=float(xy_gaps.max()))
    return out


def format_table(rows, keys=None) -> str:
    if not rows:
        return '(no rows)'
    keys = keys or list(rows[0].keys())
    widths = {k: max(len(str(k)), max(len(f'{r.get(k, "")}'[:18]) for r in rows))
              for k in keys}
    lines = ['  '.join(str(k).ljust(widths[k]) for k in keys)]
    for r in rows:
        lines.append('  '.join(f'{r.get(k, "")}'[:18].ljust(widths[k]) for k in keys))
    return '\n'.join(lines)
