"""A batched backtracking search: each game takes the first accepted trial of the
sequence alpha_0 = 1, alpha_{k+1} = tau * alpha_k (``W`` trials), or alpha_W when none
is accepted, as a per-game ``while`` loop over the trials would (the JAX versions'
``lax.while_loop`` line searches).  The trials are evaluated ``per_call`` at a time for
the games still searching, so a game that backtracks far costs a few calls, not one
call per trial.
"""
from __future__ import annotations

import torch


def backtrack(accept, searching, W: int, tau: float, dtype, device, per_call: int = 10):
    """``accept(sel, alpha)`` -> (n, T) bool: whether trial ``alpha`` (n, T) passes for
    the games ``sel`` (n,).  ``searching`` (B,) marks the games that search.  Returns
    (alpha (B,), accepted (B,)); a game that does not search gets alpha 1."""
    a = torch.ones((), dtype=dtype, device=device)
    alphas = [a]
    for _ in range(W):
        a = a * tau                 # repeated multiplication, as the loop forms it
        alphas.append(a)
    alphas = torch.stack(alphas)                                   # (W + 1,)
    B = searching.shape[0]
    k = torch.zeros(B, dtype=torch.long, device=device)            # next trial
    accepted = torch.zeros(B, dtype=torch.bool, device=device)
    searching = searching.clone()
    while W > 0 and bool(searching.any()):
        sel = torch.nonzero(searching).flatten()
        j = k[sel, None] + torch.arange(per_call, device=device)  # (n, T)
        ok = accept(sel, alphas[torch.clamp(j, max=W)]) & (j < W)
        hit = ok.any(-1)
        first = torch.argmax(ok.to(torch.uint8), dim=-1)
        k_new = torch.where(hit, j.gather(1, first[:, None])[:, 0],
                            torch.clamp(k[sel] + per_call, max=W))
        k = k.index_copy(0, sel, k_new)
        accepted = accepted.index_copy(0, sel, hit)
        searching = searching.index_copy(0, sel, ~hit & (k_new < W))
    return alphas[k], accepted
