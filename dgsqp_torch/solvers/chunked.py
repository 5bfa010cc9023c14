"""Chunked batch execution with straggler compaction, ported from
``dgsqp_tpu/solvers/chunked.py``.

The host loop runs a chunk of rounds, reads the per-game status, and, once the games
still running fit in a power-of-two bucket at most half the current batch, finalizes
the finished ones into a result store and gathers the stragglers into that smaller
bucket.  The carry is a NamedTuple of tensors with a leading batch dimension.

With a mesh of several ranks (:mod:`dgsqp_torch.parallel.mesh`) each rank holds its
block of the batch and the compaction is global, by the JAX package's rules for a
mesh-sharded batch: after each chunk the ranks gather their statuses (the chunk's one
collective), every rank computes the same bucket, rounded up to a multiple of the world
size, the live games keep their order with the pad slots repeating the first of them,
and one all-to-all moves the carry rows, ``x0`` and ``up`` to their new ranks.  Ranks
joined across hosts (``init_distributed``) keep the fixed layout, as the JAX package
does for arrays that are not fully addressable, and stop on the global count.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from dgsqp_torch.parallel.mesh import GamesMesh, pack_rows, unpack_rows


def _take(tree, idx):
    return type(tree)(*[a[idx] for a in tree])


def run_chunked_compacted(carry, x0, up, chunk_fn: Callable, *, final_fn: Callable,
                          running_status: int, max_chunks: int, min_bucket: int = 16,
                          can_compact: bool = True, verbose: bool = False,
                          print_method=print, history_fn: Optional[Callable] = None,
                          mesh=None):
    """Drive ``chunk_fn(carry, x0, up) -> carry`` to completion.

    ``carry.status`` holds each game's status code; ``final_fn(carry, x0, up)`` extracts
    the per-game result NamedTuple.  Returns
    ``(result, history)`` with the result in the original batch order; every history
    entry records the batch size the chunk ran at, and the fields of
    ``history_fn(carry)`` (over this rank's games) where it is given.  With a ``mesh``
    of several ranks the inputs are this rank's block, the batch sizes are global and
    every rank gets the whole batch's result.
    """
    if mesh is None:
        mesh = GamesMesh(1, 0, carry.status.device, (), None)
    b0 = int(carry.status.shape[0])
    if mesh.size > 1:
        sizes = mesh.all_gather(torch.tensor([b0], device=mesh.device), host=True)
        if (sizes != b0).any():
            raise ValueError(f'unequal blocks over the ranks: {sizes.tolist()}')
    B0 = b0 * mesh.size
    history = []
    extra = history_fn or (lambda c: {})
    ranks = f', {mesh.size} ranks' if mesh.size > 1 else ''

    def log(i, n_run, batch, t0, c) -> dict:
        history.append(dict(chunk=i, running=n_run, batch=batch,
                            wall_s=round(time.time() - t0, 3), **extra(c)))
        if verbose:
            print_method(f'chunk {i}: {n_run} games still running (batch {batch}{ranks})')
        return history[-1]

    loop = dict(running_status=running_status, max_chunks=max_chunks,
                min_bucket=min_bucket, log=log)
    if can_compact and mesh.size > 1 and not mesh.multi_host:
        return _run_sharded(carry, x0, up, chunk_fn, final_fn, mesh=mesh, B0=B0,
                            **loop), history
    if can_compact and mesh.size == 1:
        return _run_compacting(carry, x0, up, chunk_fn, final_fn, B0=B0, **loop), history

    # the fixed layout; across ranks the one collective a chunk gathers the statuses
    for i in range(max_chunks):
        t0 = time.time()
        carry = chunk_fn(carry, x0, up)
        n_run = int((mesh.all_gather(carry.status, host=True) == running_status).sum())
        log(i, n_run, B0, t0, carry)
        if n_run == 0:
            break
    return mesh.all_gather_rows(final_fn(carry, x0, up)), history


def _run_compacting(carry, x0, up, chunk_fn, final_fn, *, B0: int,
                    running_status: int, max_chunks: int, min_bucket: int, log):
    """The compacting chunk loop on one rank; returns the result."""
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
        log(i, n_run, int(valid_h.size), t0, carry)
        if n_run == 0:
            break
        bucket = _bucket(n_run, min_bucket)
        if bucket <= valid_h.size // 2:
            compacted = True
            res_store, carry, idx, valid, x0_c, up_c = merge(
                res_store, carry, idx, valid, x0_c, up_c, bucket, False)
            valid_h = valid.cpu().numpy()

    if not compacted:
        return final_fn(carry, x0, up)
    # merge the last bucket (including games still running when the chunks ran out)
    res_store, *_ = merge(res_store, carry, idx, valid, x0_c, up_c, 1, True)
    return res_store


def _bucket(n_run: int, min_bucket: int, multiple: int = 1) -> int:
    bucket = max(min_bucket, 1 << (n_run - 1).bit_length())
    return -(-bucket // multiple) * multiple


def _exchange(mesh, tree, pad: np.ndarray, b: int):
    """The rows of the new layout: global slot ``pad[j]`` of the current layout (blocks
    of ``b`` rows a rank) becomes slot j, and rank r keeps slots ``[r * nb, (r + 1) *
    nb)``.  One all-to-all; returns (this rank's new rows, bytes sent to other ranks)."""
    k, r = mesh.size, mesh.rank
    nb = pad.size // k
    holder = pad // b
    send, send_counts = [], []
    for d in range(k):
        want = pad[d * nb:(d + 1) * nb]
        mine = want[holder[d * nb:(d + 1) * nb] == r] - r * b
        send.append(mine)
        send_counts.append(mine.size)
    mine_new = holder[r * nb:(r + 1) * nb]
    recv_counts = [int((mine_new == s).sum()) for s in range(k)]
    packed, layout = pack_rows(tree, b)
    dev = packed.device
    rows = packed[torch.as_tensor(np.concatenate(send), device=dev)]
    recv = mesh.all_to_all_rows(rows, send_counts, recv_counts)
    # rows arrive grouped by sender, each group in slot order
    order = torch.as_tensor(np.argsort(mine_new, kind='stable'), device=dev)
    new = torch.empty_like(recv)
    new[order] = recv
    sent = (sum(send_counts) - send_counts[r]) * packed.shape[1]
    return unpack_rows(new, layout, tree), int(sent)


def _run_sharded(carry, x0, up, chunk_fn, final_fn, *, mesh, B0: int,
                 running_status: int, max_chunks: int, min_bucket: int, log):
    """The compacting chunk loop over a mesh of ranks (see the module's docstring);
    returns the whole batch's result."""
    k, r = mesh.size, mesh.rank
    dev = carry.status.device
    idx_h = np.arange(B0)            # original game of each global slot
    valid_h = np.ones(B0, bool)      # the slot holds a real game, not a pad
    have = np.zeros(B0, bool)        # games this rank finalized into its store
    store = None
    x0_c, up_c = x0, up

    def harvest(store, carry, x0_c, up_c, take: np.ndarray, idx: np.ndarray):
        res = final_fn(carry, x0_c, up_c)
        if store is None:
            store = type(res)(*[a.new_zeros((B0,) + a.shape[1:]) for a in res])
        rows = torch.as_tensor(np.where(take)[0], device=dev)
        dst = torch.as_tensor(idx[take], device=dev)
        for s, a in zip(store, res):
            s[dst] = a[rows]
        have[idx[take]] = True
        return store

    compacted = False
    for i in range(max_chunks):
        t0 = time.time()
        carry = chunk_fn(carry, x0_c, up_c)
        status_g = mesh.all_gather(carry.status, host=True)
        running = (status_g == running_status) & valid_h
        n_run = int(running.sum())
        cur = valid_h.size
        entry = log(i, n_run, cur, t0, carry)
        if n_run == 0:
            break
        bucket = _bucket(n_run, min_bucket, k)
        if bucket <= cur // 2:
            tc = time.time()
            compacted = True
            b = cur // k
            blk = slice(r * b, (r + 1) * b)
            store = harvest(store, carry, x0_c, up_c, (valid_h & ~running)[blk],
                            idx_h[blk])
            sel = np.where(running)[0]
            pad = np.concatenate([sel, np.repeat(sel[:1], bucket - sel.size)])
            (carry, x0_c, up_c), sent = _exchange(mesh, (carry, x0_c, up_c), pad, b)
            idx_h = idx_h[pad]
            valid_h = np.zeros(bucket, bool)
            valid_h[:sel.size] = True
            entry.update(compact_s=round(time.time() - tc, 3), compact_bytes=sent)

    if not compacted:
        return mesh.all_gather_rows(final_fn(carry, x0, up))
    # the last bucket: every real game, finished or still running
    b = valid_h.size // k
    blk = slice(r * b, (r + 1) * b)
    store = harvest(store, carry, x0_c, up_c, valid_h[blk], idx_h[blk])
    # each game was finalized on exactly one rank: gather the stores and take its rows
    packed, layout = pack_rows(store, B0)
    all_rows = mesh.all_gather(packed)
    owners = mesh.all_gather(torch.as_tensor(have, device=dev), host=True).reshape(k, B0)
    if (owners.sum(0) != 1).any():
        raise RuntimeError('a game was finalized on no rank or on several')
    pick = torch.as_tensor(owners.argmax(0) * B0 + np.arange(B0), device=all_rows.device)
    return unpack_rows(all_rows[pick], layout, store)
