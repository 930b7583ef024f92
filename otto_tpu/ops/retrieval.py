"""Top-k retrieval over the item embedding table.

Replaces Annoy (C++ approximate NN over 1.86M x 32 vectors, reference:
src/covisitation/inference.py:58-69, src/ranker/regular_candidate_generation.py:54-70,
src/gensim_fasttext/inference.py:40-65) with a sweep of the whole table.

Two implementations:

- :func:`topk_scan` — the exact reference: ``lax.scan`` over item blocks
  keeping a running top-k, float32 at ``Precision.HIGHEST``.
- :func:`topk_blocked` — the served path, in three stages:

  1. (Pallas kernel through Triton, :func:`_stage1`) one program scores a
     tile of queries against a block of ``block`` items in bf16 on the
     tensor cores (float32 accumulation), reduces every contiguous window of
     ``SUB`` items to its maximum and keeps the ``SURVIVORS`` best window
     maxima of the block.  The [queries, items] score matrix never reaches
     device memory.
  2. ``lax.top_k`` over the ``n_blocks * SURVIVORS`` survivors of each query.
  3. the ``k + margin`` winners are rescored exactly in float32 at
     ``Precision.HIGHEST`` and re-ranked, so returned scores are exact and
     the bf16 scoring of stage 1 only decides which items survive.

  A true top-k item is missed only if a better top-k item shares its
  ``SUB``-item window, or if ``SURVIVORS`` better windows share its block.

Metrics:
- ``dot``       score = q . x
- ``euclidean`` rank by -(||q - x||^2), computed as 2 q.x - ||x||^2 (+ const
  per query), matching Annoy's euclidean ordering.

Both return (scores [B, k], indices [B, k]) sorted descending by score.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

NEG = jnp.float32(-3.4e38)
HIGHEST = jax.lax.Precision.HIGHEST

BLOCK = 4096     # items per stage-1 program
SUB = 32         # items per window (one max each)
TILE_Q = 128     # queries per stage-1 program
SURVIVORS = 4    # window maxima each program keeps per query
NUM_WARPS = 4


def _pad_items(items: jax.Array, block: int):
    n, d = items.shape
    n_pad = (-n) % block
    if n_pad:
        items = jnp.concatenate([items, jnp.zeros((n_pad, d), items.dtype)], axis=0)
    return items, n


@partial(jax.jit, static_argnames=("k", "block", "metric"))
def topk_scan(queries: jax.Array, items: jax.Array, k: int, block: int = 8192,
              metric: str = "dot"):
    """Blocked running-top-k scan (XLA), exact in float32.

    queries: [B, D] float; items: [N, D] float.
    """
    B, D = queries.shape
    items, n = _pad_items(items, block)
    n_blocks = items.shape[0] // block
    blocks = items.reshape(n_blocks, block, D)

    if metric == "euclidean":
        sq = jnp.sum(items.astype(jnp.float32) ** 2, axis=1).reshape(n_blocks, block)
    else:
        sq = jnp.zeros((n_blocks, block), jnp.float32)

    q = queries.astype(jnp.float32)

    def step(carry, inp):
        top_s, top_i = carry
        blk, blk_sq, blk_idx = inp
        s = jnp.dot(q, blk.T.astype(jnp.float32), precision=HIGHEST,
                    preferred_element_type=jnp.float32)
        if metric == "euclidean":
            s = 2.0 * s - blk_sq[None, :]
        idx = blk_idx * block + jnp.arange(block, dtype=jnp.int32)[None, :]
        s = jnp.where(idx < n, s, NEG)
        cat_s = jnp.concatenate([top_s, jnp.broadcast_to(s, (B, block))], axis=1)
        cat_i = jnp.concatenate([top_i, jnp.broadcast_to(idx, (B, block))], axis=1)
        new_s, pos = jax.lax.top_k(cat_s, k)
        new_i = jnp.take_along_axis(cat_i, pos, axis=1)
        return (new_s, new_i), None

    init = (jnp.full((B, k), NEG, jnp.float32), jnp.full((B, k), -1, jnp.int32))
    (top_s, top_i), _ = jax.lax.scan(
        step, init, (blocks, sq, jnp.arange(n_blocks, dtype=jnp.int32)[:, None])
    )
    return top_s, top_i


def n_candidates(k: int) -> int:
    """Stage-2 winners rescored in float32: ``k`` plus a margin that absorbs
    the bf16 rank errors of stage 1."""
    return k + max(8, k // 4)


def stage1_block(n_items: int, k: int) -> int:
    """Items per stage-1 program: the largest power of two up to ``BLOCK``
    that still cuts the table into ``2 * n_candidates(k)`` blocks, so a block
    holds about half a top-k item and ``SURVIVORS`` per block lose almost
    none.  At least ``SURVIVORS`` windows."""
    target = n_items // (2 * n_candidates(k))
    return min(BLOCK, max(SUB * SURVIVORS, 1 << max(target.bit_length() - 1, 0)))


def blocked_fits(n_items: int, k: int) -> bool:
    """Whether :func:`topk_blocked` serves a table of ``n_items`` rows.  Two
    top-k items sharing a ``SUB``-item window cost about ``k * SUB / 2N`` of
    recall; the bound keeps that under 0.5%.  Smaller tables take the exact
    :func:`topk_scan`."""
    return n_items >= 100 * SUB * n_candidates(k)


def _stage1_kernel(q_ref, it_ref, bias_ref, *out_refs, sub, survivors):
    """q_ref [TQ, D] x it_ref [IB, D] -> the ``survivors`` best window maxima
    (value, global item index) of each query over this item block, sorted
    descending, one output ref per rank.

    The block is walked in ``sub``-item windows: one [TQ, sub] bf16 product
    on the tensor cores, the epilogue subtracts ``bias`` (||x||^2 for
    euclidean, 0 for dot, +inf on padding rows), and the window's maximum is
    inserted into the running sorted survivor list held in registers."""
    val_refs, idx_refs = out_refs[:survivors], out_refs[survivors:]
    tq = q_ref.shape[0]
    ib = it_ref.shape[0]
    q = q_ref[...]
    base = pl.program_id(1) * ib

    def window(t, carry):
        tops, idxs = carry
        start = pl.multiple_of(t * sub, sub)
        x = it_ref[pl.ds(start, sub), :]
        s = pl.dot(q, x, trans_b=True) - bias_ref[pl.ds(start, sub)][None, :]
        v = jnp.max(s, axis=1)
        i = jnp.argmax(s, axis=1).astype(jnp.int32) + base + start
        new_tops, new_idxs = [], []
        for top, idx in zip(tops, idxs):
            better = v > top
            new_tops.append(jnp.where(better, v, top))
            new_idxs.append(jnp.where(better, i, idx))
            v, i = jnp.where(better, top, v), jnp.where(better, idx, i)
        return tuple(new_tops), tuple(new_idxs)

    init = (tuple(jnp.full((tq,), -jnp.inf, jnp.float32) for _ in range(survivors)),
            tuple(jnp.full((tq,), -1, jnp.int32) for _ in range(survivors)))
    tops, idxs = jax.lax.fori_loop(0, ib // sub, window, init)
    for r in range(survivors):
        val_refs[r][...] = tops[r]
        idx_refs[r][...] = idxs[r]


def _stage1(q, table, bias, *, block, interpret):
    """Pallas stage 1: [Bp, D] bf16 queries x [Np, D] bf16 table -> survivors
    (values [Bp, NB*R] f32, item indices [Bp, NB*R] int32)."""
    bp, d = q.shape
    n_blocks = table.shape[0] // block
    tile = min(TILE_Q, bp)
    outs = pl.pallas_call(
        partial(_stage1_kernel, sub=SUB, survivors=SURVIVORS),
        # query tiles vary fastest, so the programs that share an item block
        # run together and read it from L2
        grid=(bp // tile, n_blocks),
        in_specs=[
            pl.BlockSpec((tile, d), lambda i, j: (i, 0)),
            pl.BlockSpec((block, d), lambda i, j: (j, 0)),
            pl.BlockSpec((block,), lambda i, j: (j,)),
        ],
        out_specs=[pl.BlockSpec((None, tile), lambda i, j: (j, i))] * (2 * SURVIVORS),
        out_shape=([jax.ShapeDtypeStruct((n_blocks, bp), jnp.float32)] * SURVIVORS
                   + [jax.ShapeDtypeStruct((n_blocks, bp), jnp.int32)] * SURVIVORS),
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=3),
        interpret=interpret,
        name="retrieval_stage1",
    )(q, table, bias)
    vals = jnp.stack(outs[:SURVIVORS], axis=-1)  # [NB, Bp, R]
    idx = jnp.stack(outs[SURVIVORS:], axis=-1)
    return (vals.transpose(1, 0, 2).reshape(bp, -1),
            idx.transpose(1, 0, 2).reshape(bp, -1))


def stage1_reference(q, table, bias, *, block):
    """Plain-XLA stage 1 with the kernel's semantics: materializes the
    [Bp, Np] scores, takes each window's max and the block's top
    ``SURVIVORS`` window maxima."""
    bp = q.shape[0]
    n_blocks = table.shape[0] // block
    s = jnp.dot(q, table.T, preferred_element_type=jnp.float32) - bias[None, :]
    w = s.reshape(bp, -1, SUB)
    v = jnp.max(w, axis=2)
    a = jnp.argmax(w, axis=2).astype(jnp.int32) + jnp.arange(
        w.shape[1], dtype=jnp.int32)[None, :] * SUB
    v = v.reshape(bp, n_blocks, block // SUB)
    a = a.reshape(bp, n_blocks, block // SUB)
    tv, tp = jax.lax.top_k(v, SURVIVORS)
    ti = jnp.take_along_axis(a, tp, axis=2)
    return tv.reshape(bp, -1), ti.reshape(bp, -1)


@partial(jax.jit, static_argnames=("k", "metric", "block", "interpret", "reference"))
def topk_blocked(queries: jax.Array, items: jax.Array, k: int, metric: str = "dot",
                 block: int | None = None, interpret: bool = False,
                 reference: bool = False):
    """Served top-k (module docstring): fused stage-1 kernel, ``top_k`` over
    the survivors, exact float32 rescoring of ``n_candidates(k)`` winners.

    queries [B, D], items [N, D]; serving callers check ``blocked_fits``.
    ``block`` defaults to :func:`stage1_block`.  ``reference=True`` runs
    :func:`stage1_reference` in place of the kernel.  Returns (scores [B, k],
    indices [B, k]) sorted descending.
    """
    b, d = queries.shape
    n = items.shape[0]
    block = block or stage1_block(n, k)
    if (n // block) * SURVIVORS < n_candidates(k):
        raise ValueError(f"{n} rows in blocks of {block} leave too few "
                         f"survivors for k={k}")
    itf = items.astype(jnp.float32)
    sq = jnp.sum(itf * itf, axis=1)
    table, _ = _pad_items(items.astype(jnp.bfloat16), block)
    bias = jnp.zeros((n,), jnp.float32) if metric == "dot" else sq
    bias = jnp.concatenate([bias, jnp.full((table.shape[0] - n,), jnp.inf, jnp.float32)])

    qf = queries.astype(jnp.float32)
    scale = 2.0 if metric == "euclidean" else 1.0
    tile = TILE_Q if b >= TILE_Q else max(16, 1 << (b - 1).bit_length())
    q1 = jnp.pad((scale * qf).astype(jnp.bfloat16), ((0, (-b) % tile), (0, 0)))
    if reference:
        vals, idx = stage1_reference(q1, table, bias, block=block)
    else:
        vals, idx = _stage1(q1, table, bias, block=block, interpret=interpret)
    vals, idx = vals[:b], idx[:b]

    top_v, pos = jax.lax.top_k(vals, n_candidates(k))
    cand = jnp.take_along_axis(idx, pos, axis=1)
    live = (top_v > -jnp.inf) & (cand >= 0) & (cand < n)
    cand = jnp.where(live, cand, 0)
    s = jnp.einsum("bd,bkd->bk", qf, itf[cand], precision=HIGHEST)
    if metric == "euclidean":
        s = 2.0 * s - sq[cand]
    s = jnp.where(live, s, NEG)
    top_s, p = jax.lax.top_k(s, k)
    top_i = jnp.take_along_axis(cand, p, axis=1)
    return top_s, jnp.where(top_s > NEG / 2, top_i, -1)


def build_neighbor_table(
    embeddings: np.ndarray,
    k: int,
    metric: str = "euclidean",
    exclude_self: bool = True,
    query_batch: int = 4096,
    block: int = 16384,
    scores_out: bool = False,
    exact: bool = False,
    interpret: bool = False,
):
    """All-items kNN table: for every aid, its top-k nearest aids.

    Replaces the reference's per-query ``annoy.get_nns_by_item`` with one
    batched sweep; returns int32 [N, k] (+ float32 scores when requested).
    ``exclude_self`` drops the query aid itself from its row (the reference
    skips neighbor 0 — inference.py:167).  Tables large enough for
    :func:`topk_blocked` (``blocked_fits``) take it; smaller ones, or
    ``exact=True``, take the exact :func:`topk_scan` with ``block``-row scan
    blocks.
    """
    n = embeddings.shape[0]
    fetch = k + 1 if exclude_self else k
    use_blocked = not exact and blocked_fits(n, fetch)
    out = np.empty((n, k), np.int32)
    out_s = np.empty((n, k), np.float32) if scores_out else None
    items = jnp.asarray(embeddings)
    for start in range(0, n, query_batch):
        end = min(start + query_batch, n)
        q = items[start:end]
        pad = query_batch - (end - start)
        if pad:
            q = jnp.concatenate([q, jnp.zeros((pad, q.shape[1]), q.dtype)], axis=0)
        if use_blocked:
            s, i = topk_blocked(q, items, k=fetch, metric=metric, interpret=interpret)
        else:
            s, i = topk_scan(q, items, k=fetch, block=block, metric=metric)
        s = np.asarray(s[: end - start])
        i = np.asarray(i[: end - start])
        if exclude_self:
            rows = np.arange(start, end)[:, None]
            keep = i != rows
            # at most one self entry per row, so keep has >= k True columns;
            # stable argsort moves them left in original (descending) order
            cols = np.argsort(~keep, axis=1, kind="stable")[:, :k]
            r_idx = np.arange(end - start)[:, None]
            out[start:end] = i[r_idx, cols]
            if scores_out:
                out_s[start:end] = s[r_idx, cols]
        else:
            out[start:end] = i[:, :k]
            if scores_out:
                out_s[start:end] = s[:, :k]
    return (out, out_s) if scores_out else out
