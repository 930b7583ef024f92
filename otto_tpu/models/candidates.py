"""Candidate generation for the two-stage ranker (reference L6a).

Four generators mirroring src/ranker/:

- :func:`regular_candidates` — the production generator
  (regular_candidate_generation.py:138-197): session unique aids
  (recency-ordered, scores = descending ranks) + covisitation-vote top-100
  (vote counts as scores) + embedding kNN of the last aid, with binary labels
  and a max-recall ceiling report.
- :func:`covisit_candidates` — covisitation votes only
  (covisitation_candidate_generation.py:108-157).
- :func:`recency_candidates` — session-history-only recency weights with
  type coefficients {click:1, cart:6, order:1}
  (recency_weighted_candidate_generator.py:24,61-105).
- :func:`embedding_candidates` — kNN of the last session aid with distances
  as scores (fasttext_candidate_generator.py:36-48).

Candidates are fixed-shape ``[S, C]`` padded arrays (no exploded pickles);
:meth:`CandidateSet.flatten` recovers the reference's flat
(session, candidate, score, label) layout when needed.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from otto_tpu import EVENT_TYPES, TOP_K
from otto_tpu.data.events import EventStore
from otto_tpu.data.labels import SessionLabels
from otto_tpu.eval.metrics import corpus_recall_at_k, weighted_recall
from otto_tpu.logging_utils import get_logger
from otto_tpu.models.covisitation import CovisitationMatrices
from otto_tpu.ops.multiset import (
    gather_neighbors,
    mask_members,
    row_weight_topk,
    sorted_unique_rows,
)
from otto_tpu.ops.sessions import distinct_recent_first, recency_weighted_top_aids

log = get_logger(__name__)

RECENCY_CANDGEN_COEFF = (1.0, 6.0, 1.0)


@dataclass
class CandidateSet:
    """Per-event-type candidate lists for a batch of sessions."""

    session_ids: np.ndarray  # [S]
    candidates: dict[str, np.ndarray]  # etype -> int32 [S, C] padded -1
    scores: dict[str, np.ndarray]  # etype -> float32 [S, C]
    labels: dict[str, np.ndarray] | None = None  # etype -> int8 [S, C]

    @property
    def n_sessions(self) -> int:
        return len(self.session_ids)

    def width(self, etype: str) -> int:
        return self.candidates[etype].shape[1]

    def flatten(self, etype: str):
        """Reference-style flat arrays (session, candidate, score[, label])."""
        cands = self.candidates[etype]
        valid = cands >= 0
        sess = np.repeat(self.session_ids, valid.sum(axis=1))
        flat_c = cands[valid]
        flat_s = self.scores[etype][valid]
        if self.labels is not None:
            return sess, flat_c, flat_s, self.labels[etype][valid]
        return sess, flat_c, flat_s

    def max_recall_report(self, labels: SessionLabels) -> dict[str, float]:
        """Candidate max-recall ceiling (corpus-level, clip-20 denominator) —
        the bound any reranker can achieve
        (regular_candidate_generation.py:203-223)."""
        out = {}
        for etype in EVENT_TYPES:
            r = corpus_recall_at_k(
                jnp.asarray(self.candidates[etype]), jnp.asarray(labels.padded(etype)), k=TOP_K
            )
            out[etype] = float(r)
        out["weighted"] = weighted_recall(out["clicks"], out["carts"], out["orders"])
        log.info(
            "candidate max recalls: clicks %.6f carts %.6f orders %.6f weighted %.6f",
            out["clicks"], out["carts"], out["orders"], out["weighted"],
        )
        return out


@jax.jit
def _compact_two(values: jax.Array, scores: jax.Array):
    """Left-compact (value, score) pairs where value >= 0, preserving order."""
    S, K = values.shape
    invalid = (values < 0).astype(jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32), (S, K))
    _, _, v, s = jax.lax.sort((invalid, pos, values, scores), dimension=1, num_keys=2)
    return v, jnp.where(v >= 0, s, 0.0)


@jax.jit
def _attach_labels(candidates: jax.Array, click_label: jax.Array, cart_padded: jax.Array, order_padded: jax.Array):
    click = (candidates == click_label[:, None]) & (candidates >= 0)
    cart = jnp.any(
        (candidates[:, :, None] == cart_padded[:, None, :]) & (cart_padded >= 0)[:, None, :],
        axis=2,
    )
    order = jnp.any(
        (candidates[:, :, None] == order_padded[:, None, :]) & (order_padded >= 0)[:, None, :],
        axis=2,
    )
    return click.astype(jnp.int8), cart.astype(jnp.int8), order.astype(jnp.int8)


def _label_dict(cand_dict, labels: SessionLabels):
    cart_p = jnp.asarray(labels.padded("carts"))
    order_p = jnp.asarray(labels.padded("orders"))
    click = jnp.asarray(labels.click)
    out = {}
    for etype in EVENT_TYPES:
        cl, ca, orr = _attach_labels(jnp.asarray(cand_dict[etype]), click, cart_p, order_p)
        out[etype] = np.asarray({"clicks": cl, "carts": ca, "orders": orr}[etype])
    return out


@partial(jax.jit, static_argnames=("k_covisit",))
def _vote_block(vals, uniq_recent, k_covisit):
    """Vote-count top-k + session-aid exclusion + compaction for one list.

    A separate small jit per list shape: carts/orders share shapes (one
    compile serves both) and each program stays small enough for the remote
    compiler."""
    top, votes = row_weight_topk(vals, jnp.ones_like(vals, jnp.float32), vals >= 0, k_covisit)
    return _compact_two(mask_members(top, uniq_recent), votes)


@partial(jax.jit, static_argnames=("uniq_cap", "vote_cap"))
def _session_lists(aids, types, lengths, uniq_cap, vote_cap):
    """Derives the validity mask and last aid on device (pack keep='last'
    left-aligns short sessions: valid cols 0..min(len,L)-1, last event at
    column min(len,L)-1 — column -1 would read padding)."""
    L = aids.shape[1]
    clipped = jnp.minimum(lengths, L).astype(jnp.int32)
    mask = jnp.arange(L, dtype=jnp.int32)[None, :] < clipped[:, None]
    last_aid = jnp.take_along_axis(aids, jnp.maximum(clipped - 1, 0)[:, None], axis=1)
    uniq_recent = distinct_recent_first(aids, mask, k=uniq_cap)
    clickcart = sorted_unique_rows(jnp.where(types <= 1, aids, -1), mask, min(vote_cap, uniq_cap))
    n_uniq = jnp.sum(uniq_recent >= 0, axis=1)
    col = jnp.arange(uniq_cap, dtype=jnp.float32)[None, :]
    hist_scores = jnp.where(uniq_recent >= 0, n_uniq[:, None].astype(jnp.float32) - col, 0.0)
    return uniq_recent, clickcart, hist_scores, last_aid


def _regular_chunk(aids, types, lengths, tables_tuple, ft_table, uniq_cap, wide_k, k_covisit,
                   with_ft, vote_cap=32):
    """One chunk of the regular generator: returns per-type (candidates,
    scores) of width uniq_cap + k_covisit regardless of the chunk's packed
    width L (narrow chunks pad their history section with -1 columns).

    ``vote_cap`` bounds the per-session source lists feeding the vote gathers
    (the concatenated row width drives the row-sort compile cost
    superlinearly; sessions with more than vote_cap distinct source aids are
    rare and lose only their least-recent vote sources)."""
    (t_time, t_clickw, t_cartw, t_clickcart, t_cartorder) = tables_tuple
    S, L = aids.shape
    list_cap = min(uniq_cap, L)  # a session of <= L events has <= L distinct aids
    uniq_recent, clickcart, hist_scores, last_aid = _session_lists(
        aids, types, lengths, list_cap, vote_cap
    )
    vote_src = uniq_recent[:, : min(vote_cap, list_cap)]

    g_time = gather_neighbors(t_time[:, :wide_k], vote_src)
    g_clickw = gather_neighbors(t_clickw[:, :wide_k], clickcart)
    g_cartw = gather_neighbors(t_cartw[:, :wide_k], clickcart)
    g_clickcart = gather_neighbors(t_clickcart[:, :wide_k], clickcart)
    g_cartorder = gather_neighbors(t_cartorder[:, :wide_k], clickcart)
    if with_ft:
        ft_list = gather_neighbors(ft_table, last_aid)
    else:
        ft_list = jnp.full((S, 0), -1, jnp.int32)

    lists = {
        "clicks": jnp.concatenate(
            [g_time, g_clickw, g_cartw, g_clickcart, g_cartorder, ft_list], axis=1
        ),
        "carts": jnp.concatenate([g_time, g_cartw, g_cartorder, ft_list], axis=1),
        "orders": jnp.concatenate([g_time, g_cartw, g_cartorder, ft_list], axis=1),
    }

    # pad the history section to uniq_cap so the [history | covisit] column
    # layout is identical for every packed width (the history section is
    # already -1-padded internally, so extra -1 columns are transparent)
    pad_cols = uniq_cap - list_cap
    if pad_cols:
        uniq_hist = jnp.pad(uniq_recent, ((0, 0), (0, pad_cols)), constant_values=-1)
        hist_scores = jnp.pad(hist_scores, ((0, 0), (0, pad_cols)))
    else:
        uniq_hist = uniq_recent

    out = {}
    for etype in EVENT_TYPES:
        filt, filt_scores = _vote_block(lists[etype], uniq_recent, k_covisit)
        cands = jnp.concatenate([uniq_hist, filt], axis=1)
        scores = jnp.concatenate([hist_scores, filt_scores], axis=1)
        out[etype] = (cands, scores)
    return out


def _chunked(packed, fn, S, chunk, lookahead: int = 4):
    """Run ``fn`` over fixed-shape session chunks with a dispatch lookahead:
    up to ``lookahead`` chunks stay in flight so device compute overlaps the
    host-link result fetches (the fetch of chunk i otherwise serializes the
    dispatch of chunk i+1 — a large loss when the link is slow)."""
    from collections import deque

    outs = None

    def dispatch(start):
        sel = np.arange(start, min(start + chunk, S))
        pad = chunk - len(sel)
        idx = np.concatenate([sel, np.zeros(pad, np.int64)]) if pad else sel
        mask = packed.mask[idx]
        if pad:
            mask = mask.copy()
            mask[len(sel):] = False
        res = fn(
            jnp.asarray(packed.aids[idx]),
            jnp.asarray(packed.types[idx]),
            jnp.asarray(mask),
            jnp.asarray(packed.lengths[idx]),
        )
        return res, len(sel)

    def drain(item):
        nonlocal outs
        res, n_sel = item
        if outs is None:
            outs = {k: ([], []) for k in res}
        for k, (c, s) in res.items():
            outs[k][0].append(np.asarray(c)[:n_sel])
            outs[k][1].append(np.asarray(s)[:n_sel])

    inflight = deque()
    for start in range(0, S, chunk):
        inflight.append(dispatch(start))
        if len(inflight) > lookahead:
            drain(inflight.popleft())
    while inflight:
        drain(inflight.popleft())
    return {k: (np.concatenate(cs), np.concatenate(ss)) for k, (cs, ss) in outs.items()}


def regular_candidates(
    store: EventStore,
    matrices: CovisitationMatrices,
    ft_neighbors: np.ndarray | None = None,
    labels: SessionLabels | None = None,
    uniq_cap: int = 64,
    wide_k: int = 20,
    k_covisit: int = 100,
    max_len: int = 256,
    chunk_sessions: int = 2048,
    vote_cap: int = 32,
    mesh=None,
) -> CandidateSet:
    """The production candidate generator.

    With ``mesh``, sessions shard over the mesh's ``data`` axis and the
    covisitation/kNN tables shard row-wise over ``model``
    (:mod:`otto_tpu.parallel.serving`); predictions equal the single-device
    path (tests/test_sharded_serving.py)."""
    packed = store.pack(max_len=max_len, keep="last")
    with_ft = ft_neighbors is not None
    sharded_fn = None
    if mesh is not None:
        from otto_tpu.parallel.serving import (
            CANDGEN_TABLE_KINDS,
            make_sharded_regular_chunk,
            pad_table_rows,
        )

        msize = mesh.shape["model"]
        dsize = mesh.shape["data"]
        chunk_sessions = -(-chunk_sessions // dsize) * dsize
        tt = tuple(
            jnp.asarray(pad_table_rows(matrices.tables[k][0][:, :wide_k], msize))
            for k in CANDGEN_TABLE_KINDS
        )
        ft = (jnp.asarray(pad_table_rows(ft_neighbors, msize)) if with_ft
              else jnp.zeros((msize, 1), jnp.int32))
        sharded_fn = make_sharded_regular_chunk(
            mesh, uniq_cap, wide_k, k_covisit, with_ft, vote_cap
        )
    else:
        tt = tuple(
            jnp.asarray(matrices.tables[k][0])
            for k in ("time_weighted", "click_weighted", "cart_weighted", "click_cart", "cart_order")
        )
        ft = jnp.asarray(ft_neighbors) if with_ft else jnp.zeros((1, 1), jnp.int32)

    # length-bucketed chunking: short sessions ship as [chunk, 32] slices
    # (exact under the left-aligned keep='last' layout), cutting host->device
    # bytes ~8x for the common case; the output layout is width-independent.
    S = store.n_sessions
    C = uniq_cap + k_covisit
    cands = {t: np.full((S, C), -1, np.int32) for t in EVENT_TYPES}
    scores = {t: np.zeros((S, C), np.float32) for t in EVENT_TYPES}
    clens = np.minimum(store.lengths, packed.max_len)
    lo = 0
    for width in (w for w in (32, packed.max_len) if w <= packed.max_len):
        idx = np.flatnonzero((clens > lo) & (clens <= width))
        lo = width
        for start in range(0, len(idx), chunk_sessions):
            sel = idx[start : start + chunk_sessions]
            pad = chunk_sessions - len(sel)
            sel_p = np.concatenate([sel, np.zeros(pad, np.int64)]) if pad else sel
            chunk_args = (
                jnp.asarray(packed.aids[sel_p, :width]),
                jnp.asarray(packed.types[sel_p, :width]),
                jnp.asarray(np.minimum(packed.lengths[sel_p], width)),
            )
            if sharded_fn is not None:
                res = sharded_fn(*chunk_args, *tt, ft)
            else:
                res = _regular_chunk(
                    *chunk_args, tt, ft, uniq_cap, wide_k, k_covisit, with_ft, vote_cap,
                )
            for t in EVENT_TYPES:
                c, s = res[t]
                cands[t][sel] = np.asarray(c)[: len(sel)]
                scores[t][sel] = np.asarray(s)[: len(sel)]
    lab = _label_dict(cands, labels) if labels is not None else None
    cs = CandidateSet(store.session_ids.copy(), cands, scores, lab)
    if labels is not None:
        cs.max_recall_report(labels)
    return cs


def recency_candidates(
    store: EventStore,
    labels: SessionLabels | None = None,
    uniq_cap: int = 64,
    max_len: int = 256,
    chunk_sessions: int = 4096,
) -> CandidateSet:
    """Session-history-only recency-weighted candidates."""
    packed = store.pack(max_len=max_len, keep="last")
    coeff = jnp.asarray(RECENCY_CANDGEN_COEFF, jnp.float32)
    lo = {"clicks": 0.1, "carts": 0.5, "orders": 0.5}

    def fn(a, t, m, lens):
        out = {}
        for etype in EVENT_TYPES:
            c, w = recency_weighted_top_aids(a, t, m, lens, coeff, k=uniq_cap, lo=lo[etype], hi=1.0)
            out[etype] = (c, jnp.where(c >= 0, w, 0.0))
        return out

    res = _chunked(packed, fn, store.n_sessions, chunk_sessions)
    cands = {k: v[0] for k, v in res.items()}
    scores = {k: v[1] for k, v in res.items()}
    lab = _label_dict(cands, labels) if labels is not None else None
    cs = CandidateSet(store.session_ids.copy(), cands, scores, lab)
    if labels is not None:
        cs.max_recall_report(labels)
    return cs


def covisit_candidates(
    store: EventStore,
    matrices: CovisitationMatrices,
    labels: SessionLabels | None = None,
    uniq_cap: int = 64,
    wide_k: int = 15,
    k_covisit: int = 100,
    max_len: int = 256,
    chunk_sessions: int = 2048,
) -> CandidateSet:
    """Covisitation-votes-only candidates (no history, no embeddings)."""
    packed = store.pack(max_len=max_len, keep="last")
    tt = tuple(
        jnp.asarray(matrices.tables[k][0])
        for k in ("time_weighted", "click_weighted", "cart_weighted", "click_cart", "cart_order")
    )

    def fn(a, t, m, lens):
        res = _regular_chunk(
            a, t, lens, tt, jnp.zeros((1, 1), jnp.int32), uniq_cap, wide_k, k_covisit, False
        )
        # drop the history prefix: keep only the covisitation block
        return {k: (c[:, uniq_cap:], s[:, uniq_cap:]) for k, (c, s) in res.items()}

    res = _chunked(packed, fn, store.n_sessions, chunk_sessions)
    cands = {k: v[0] for k, v in res.items()}
    scores = {k: v[1] for k, v in res.items()}
    lab = _label_dict(cands, labels) if labels is not None else None
    cs = CandidateSet(store.session_ids.copy(), cands, scores, lab)
    if labels is not None:
        cs.max_recall_report(labels)
    return cs


def embedding_candidates(
    store: EventStore,
    ft_neighbors: np.ndarray,
    ft_scores: np.ndarray,
    labels: SessionLabels | None = None,
) -> CandidateSet:
    """kNN-of-last-aid candidates with similarity scores
    (fasttext_candidate_generator.py:75-98)."""
    last = store.last_aid()
    cands_row = ft_neighbors[last].astype(np.int32)
    scores_row = ft_scores[last].astype(np.float32)
    cands = {etype: cands_row for etype in EVENT_TYPES}
    scores = {etype: scores_row for etype in EVENT_TYPES}
    lab = _label_dict(cands, labels) if labels is not None else None
    cs = CandidateSet(store.session_ids.copy(), cands, scores, lab)
    if labels is not None:
        cs.max_recall_report(labels)
    return cs
