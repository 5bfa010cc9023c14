"""Chunked batch execution with straggler compaction, ported from
``dgsqp_tpu/solvers/chunked.py`` (the fixed-layout loop and the single-device
compaction; the mesh-sharded path is not ported).

The host loop runs a chunk of rounds, reads the per-game status, and, once the games
still running fit in a power-of-two bucket at most half the current batch, finalizes
the finished ones into a result store and gathers the stragglers into that smaller
bucket.  The carry is a NamedTuple of tensors with a leading batch dimension.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch


def _take(tree, idx):
    return type(tree)(*[a[idx] for a in tree])


def run_chunked_compacted(carry, x0, up, chunk_fn: Callable, *, final_fn: Callable,
                          running_status: int, max_chunks: int, min_bucket: int = 16,
                          can_compact: bool = True, verbose: bool = False,
                          print_method=print, history_fn: Optional[Callable] = None):
    """Drive ``chunk_fn(carry, x0, up) -> carry`` to completion.

    ``carry.status`` holds each game's status code; ``final_fn(carry, x0, up)`` extracts
    the per-game result NamedTuple.  Returns
    ``(result, history)`` with the result in the original batch order; every history
    entry records the batch size the chunk ran at, and the fields of
    ``history_fn(carry)`` where it is given.
    """
    B0 = int(carry.status.shape[0])
    history = []

    if not can_compact:
        for i in range(max_chunks):
            t0 = time.time()
            carry = chunk_fn(carry, x0, up)
            n_run = int((carry.status == running_status).sum())
            history.append(dict(chunk=i, running=n_run, batch=B0,
                                wall_s=round(time.time() - t0, 3),
                                **(history_fn(carry) if history_fn else {})))
            if verbose:
                print_method(f'chunk {i}: {n_run} games still running (fixed layout)')
            if n_run == 0:
                break
        return final_fn(carry, x0, up), history

    dev = carry.status.device
    x0_c, up_c = x0, up
    idx = torch.arange(B0, device=dev)
    valid = torch.ones(B0, dtype=torch.bool, device=dev)
    valid_h = valid.cpu().numpy()
    res_store = None
    compacted = False

    def merge(res_store, carry, idx, valid, x0_c, up_c, k: int, take_all: bool):
        """Finalize the bucket, merge its harvestable games into the full-batch result
        store, and gather the first k running slots (original order kept)."""
        status = carry.status
        running = (status == running_status) & valid
        res_b = final_fn(carry, x0_c, up_c)
        if res_store is None:
            res_store = type(res_b)(*[a.new_zeros((B0,) + a.shape[1:]) for a in res_b])
        harvestable = valid & (torch.ones_like(running) if take_all else ~running)
        midx = torch.where(valid, idx, B0)
        take = torch.zeros(B0 + 1, dtype=torch.bool, device=dev).scatter(
            0, midx, harvestable)[:B0]
        inv = torch.zeros(B0 + 1, dtype=torch.long, device=dev).scatter(
            0, midx, torch.arange(idx.shape[0], device=dev))[:B0]
        res_store = type(res_b)(*[
            torch.where(take.reshape((B0,) + (1,) * (r.dim() - 1)), r[inv], s)
            for s, r in zip(res_store, res_b)])
        order = torch.argsort((~running).to(torch.int8), stable=True)
        sel = order[:k]
        new_idx = idx[sel]
        new_valid = running[sel]
        safe = torch.where(new_valid, new_idx, 0)
        return res_store, _take(carry, sel), new_idx, new_valid, x0[safe], up[safe]

    for i in range(max_chunks):
        t0 = time.time()
        carry = chunk_fn(carry, x0_c, up_c)
        status_h = carry.status.cpu().numpy()
        running = (status_h == running_status) & valid_h
        n_run = int(running.sum())
        history.append(dict(chunk=i, running=n_run, batch=int(valid_h.size),
                            wall_s=round(time.time() - t0, 3),
                            **(history_fn(carry) if history_fn else {})))
        if verbose:
            print_method(f'chunk {i}: {n_run} games still running (batch {valid_h.size})')
        if n_run == 0:
            break
        bucket = max(min_bucket, 1 << (n_run - 1).bit_length())
        if bucket <= valid_h.size // 2:
            compacted = True
            res_store, carry, idx, valid, x0_c, up_c = merge(
                res_store, carry, idx, valid, x0_c, up_c, bucket, False)
            valid_h = valid.cpu().numpy()

    if not compacted:
        return final_fn(carry, x0, up), history
    # merge the last bucket (including games still running when the chunks ran out)
    res_store, *_ = merge(res_store, carry, idx, valid, x0_c, up_c, 1, True)
    return res_store, history
