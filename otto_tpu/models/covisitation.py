"""Covisitation matrices: construction, persistence, and the heuristic
recommender (the reference's strongest non-ranker model,
src/covisitation/inference.py).

Construction (absent from the reference repo — it consumed external parquet
shards) runs the chunked device pipeline in :mod:`otto_tpu.ops.covisit`:
pair-stream -> on-device sort/segment-reduce -> host accumulator merge ->
per-aid top-k tables.  The resulting dense ``[n_aids, K]`` neighbor tables
replace the reference's dict-of-lists (covisitation_df_to_dict,
src/covisitation/inference.py:19-35) with a single device gather.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from otto_tpu.config import COVISIT_KINDS, CovisitConfig
from otto_tpu.data.events import EventStore
from otto_tpu.logging_utils import get_logger
from otto_tpu.ops.covisit import (
    PairAccumulator,
    compact_live,
    pair_stream,
    sort_reduce_rows,
    topk_per_source,
)

log = get_logger(__name__)


@dataclass
class CovisitationMatrices:
    """Per-kind dense top-k neighbor tables.

    ``tables[kind] = (aids int32 [n_aids, K] padded -1, weights float32)``.
    The "top_15_*" (narrow) and "top_*" (wide) shard families of the reference
    are just different K slices of the same tables."""

    tables: dict[str, tuple[np.ndarray, np.ndarray]]
    n_aids: int

    def neighbors(self, kind: str, k: int | None = None) -> np.ndarray:
        aids, _ = self.tables[kind]
        return aids if k is None else aids[:, :k]

    def save(self, directory: str | Path) -> None:
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        for kind, (aids, weights) in self.tables.items():
            np.savez_compressed(directory / f"covisit_{kind}.npz", aids=aids, weights=weights)

    @classmethod
    def load(cls, directory: str | Path, kinds=COVISIT_KINDS) -> "CovisitationMatrices":
        directory = Path(directory)
        tables = {}
        n_aids = 0
        for kind in kinds:
            z = np.load(directory / f"covisit_{kind}.npz")
            tables[kind] = (z["aids"], z["weights"])
            n_aids = z["aids"].shape[0]
        return cls(tables=tables, n_aids=n_aids)


def build_covisitation(
    store: EventStore,
    n_aids: int,
    config: CovisitConfig = CovisitConfig(),
    chunk_sessions: int = 2048,
    mesh=None,
    budget_rows: int | None = 64_000_000,
    per_aid_cap: int = 128,
    stats_out: dict | None = None,
    progress_cb=None,
) -> CovisitationMatrices:
    """Build all seven matrices in one pass over the event data.

    Every chunk is padded to exactly ``chunk_sessions`` so the device programs
    compile once per (chunk_sessions, session_tail) shape — XLA's sort is
    slow to *compile* at millions of elements, so shape
    stability plus the persistent compilation cache is what makes construction
    cheap.  With ``mesh`` given, each chunk's sessions shard across the mesh's
    data axis and every device runs the pair-stream + sort-reduce on its shard
    (chunk_sessions is rounded up to a multiple of the axis size).

    Host memory is bounded by ``budget_rows`` (~36 B/row): the accumulator
    merge-reduces and prunes each aid to its running top ``per_aid_cap``
    co-visitors whenever the buffer exceeds the budget
    (:class:`otto_tpu.ops.covisit.PairAccumulator`).  ``budget_rows=None``
    keeps every distinct pair (exact, unbounded — the round-1 behavior).

    ``progress_cb(events_done, acc)`` fires after every drained chunk so a
    multi-hour full-corpus build can flush partial evidence (events/s, RSS,
    accumulator pressure) — a killed run still leaves a measured rate."""
    T = config.session_tail
    if store.n_events == 0:
        empty = (np.full((n_aids, config.top_k_wide), -1, np.int32),
                 np.zeros((n_aids, config.top_k_wide), np.float32))
        return CovisitationMatrices({k: empty for k in config.kinds}, n_aids)
    t0 = np.int64(store.ts.min())
    t1 = np.int64(store.ts.max())
    type_mult = jnp.asarray(
        [config.click_weight, config.cart_weight, config.order_weight], jnp.float32
    )

    acc = PairAccumulator(n_aids, budget_rows=budget_rows, per_aid_cap=per_aid_cap)
    packed = store.pack(max_len=T, keep="last")
    rel_ts = (packed.ts - t0).astype(np.int32)  # spans weeks, fits int32
    S = packed.n_sessions
    plens = np.minimum(packed.lengths, T).astype(np.int64)

    # length buckets: a session with <= t events travels as a [chunk, t]
    # slice (pack left-aligns), shrinking the t^2 pair grid — and with it the
    # per-row sort, the weight materialization, and HBM traffic — by ~(T/t)^2
    # for the short-session majority.  Chunk order across buckets is
    # irrelevant: the host merge re-reduces by key.
    widths = [t for t in (8, 16) if t < T] + [T]
    bucket_of = np.searchsorted(np.asarray(widths), plens)

    sharded_fn = None
    if mesh is not None:
        from otto_tpu.ops.covisit import make_sharded_pair_reduce

        dsize = mesh.shape["data"]
        chunk_sessions = -(-chunk_sessions // dsize) * dsize
        sharded_fn = make_sharded_pair_reduce(mesh, n_aids)

    def dispatch(idx: np.ndarray, t: int):
        """Launch one chunk's device work (sessions ``idx`` at tail width
        ``t``); returns fetch handles only."""
        a = packed.aids[idx, :t]
        ty = packed.types[idx, :t]
        rt = rel_ts[idx, :t]
        mk = packed.mask[idx, :t]
        if len(a) < chunk_sessions:
            # pad to the fixed chunk shape: one compiled program per width
            pad = chunk_sessions - len(a)
            a = np.concatenate([a, np.zeros((pad, t), a.dtype)])
            ty = np.concatenate([ty, np.zeros((pad, t), ty.dtype)])
            rt = np.concatenate([rt, np.zeros((pad, t), rt.dtype)])
            mk = np.concatenate([mk, np.zeros((pad, t), bool)])
        args = (
            jnp.asarray(a), jnp.asarray(ty), jnp.asarray(rt), jnp.asarray(mk),
        )
        tail = (
            jnp.float32(t1 - t0), type_mult,
            jnp.int32(config.window_seconds), jnp.int32(14 * 24 * 60 * 60),
        )
        ev = int(mk.sum())
        if sharded_fn is not None:
            sx, sy, totals, live = sharded_fn(*args, *tail)
            return ev, ("full", sx, sy, totals, live)
        kx, ky, weights = pair_stream(*args, n_aids, *tail)
        cs = len(a)
        sx, sy, totals, live = sort_reduce_rows(
            kx.reshape(cs, t * t), ky.reshape(cs, t * t),
            weights.reshape(cs, t * t, -1),
        )
        # device-side compaction: fetch only ~live rows over the host link.
        # The buffer size comes from a host-side upper bound on the live
        # count (a session of packed length l emits at most l*(l-1) ordered
        # pairs), rounded up a power-of-4 ladder — no device round-trip, so
        # chunk dispatches stay pipelined, and only a handful of buffer
        # shapes ever compile.
        lens = mk.sum(axis=1).astype(np.int64)
        bound = int(np.sum(lens * np.maximum(lens - 1, 0)))
        cap = 1 << 16
        while cap < bound and cap < int(sx.shape[0]):
            cap *= 4
        cap = min(cap, max(int(sx.shape[0]), 1 << 16))
        sx_c, sy_c, totals_c, n_live = compact_live(sx, sy, totals, live, cap)
        return ev, ("compact", sx_c, sy_c, totals_c, n_live, cap, (sx, sy, totals, live))

    events_done = 0

    def drain(item):
        nonlocal events_done
        ev, handle = item
        if handle[0] == "full":
            _, sx, sy, totals, live = handle
            live_np = np.asarray(live)
            sx_np = np.asarray(sx)[live_np].astype(np.int64)
            sy_np = np.asarray(sy)[live_np].astype(np.int64)
            w_np = np.asarray(totals)[live_np]
        else:
            _, sx_c, sy_c, totals_c, n_live, cap, fallback = handle
            n = int(n_live)
            if n <= cap:
                # fetch the fixed-cap buffers (device-side slicing to a
                # varying n would recompile per chunk) and slice on host
                sx_np = np.asarray(sx_c)[:n].astype(np.int64)
                sy_np = np.asarray(sy_c)[:n].astype(np.int64)
                w_np = np.asarray(totals_c)[:n]
            else:  # overflow: fall back to the full fetch
                sx, sy, totals, live = fallback
                live_np = np.asarray(live)
                sx_np = np.asarray(sx)[live_np].astype(np.int64)
                sy_np = np.asarray(sy)[live_np].astype(np.int64)
                w_np = np.asarray(totals)[live_np]
        acc.add(sx_np * n_aids + sy_np, w_np)
        events_done += ev

    # lookahead pipeline: keep a few chunks in flight so device compute and
    # host-link fetches overlap instead of ping-ponging per chunk
    import time as _time
    from collections import deque

    t_dispatch = t_drain = 0.0
    lookahead = 4
    inflight: deque = deque()
    for bi, t in enumerate(widths):
        idx_all = np.flatnonzero(bucket_of == bi)
        for start in range(0, len(idx_all), chunk_sessions):
            _t0 = _time.perf_counter()
            inflight.append(dispatch(idx_all[start : start + chunk_sessions], t))
            t_dispatch += _time.perf_counter() - _t0
            if len(inflight) > lookahead:
                _t0 = _time.perf_counter()
                drain(inflight.popleft())
                t_drain += _time.perf_counter() - _t0
                # callback OUTSIDE the timed section: artifact flushes/prints
                # must not bias the dispatch-vs-drain attribution split
                if progress_cb is not None:
                    progress_cb(events_done, acc)
    while inflight:
        _t0 = _time.perf_counter()
        drain(inflight.popleft())
        t_drain += _time.perf_counter() - _t0
        if progress_cb is not None:
            progress_cb(events_done, acc)
    # dispatch time = host prep + enqueue (device runs async); drain time =
    # result fetch + host merge — the split that separates a slow device
    # from a slow host
    log.info("covisitation build: dispatch %.1fs, drain(fetch+merge) %.1fs",
             t_dispatch, t_drain)
    if stats_out is not None:
        stats_out["dispatch_s"] = round(t_dispatch, 1)
        stats_out["drain_s"] = round(t_drain, 1)
        stats_out["compaction_log"] = list(acc.compaction_log)

    keys, weights = acc.finish()
    if not len(keys):
        empty = (np.full((n_aids, config.top_k_wide), -1, np.int32),
                 np.zeros((n_aids, config.top_k_wide), np.float32))
        return CovisitationMatrices({k: empty for k in config.kinds}, n_aids)
    log.info(
        "covisitation: %d distinct pairs aggregated (peak buffer %d rows, "
        "%d compactions, %d rows pruned)",
        len(keys), acc.peak_rows, acc.n_compactions, acc.rows_pruned,
    )

    aid_x = (keys // n_aids).astype(np.int64)
    aid_y = (keys % n_aids).astype(np.int32)
    tables = {}
    for i, kind in enumerate(COVISIT_KINDS):
        if kind not in config.kinds:
            continue
        tables[kind] = topk_per_source(aid_x, aid_y, weights[:, i], n_aids, config.top_k_wide)
    return CovisitationMatrices(tables=tables, n_aids=n_aids)


# ---------------------------------------------------------------------------
# Heuristic recommender (reference: src/covisitation/inference.py validation/
# submission bodies).  Sessions with >= 20 distinct aids are scored by typed
# log-recency weights plus neighbor bonuses ("recency_weight" route,
# inference.py:128-133,143-199); the rest are scored by covisitation voting
# ("covisitation" route, :204-247).  Both routes are batched device kernels;
# the routing itself is a host partition so each branch only processes its own
# sessions.
# ---------------------------------------------------------------------------

from functools import partial

import jax

from otto_tpu import EVENT_TYPES, TOP_K
from otto_tpu.ops.multiset import (
    compact_rows,
    concat_unique_cascade,
    gather_neighbors,
    mask_members,
    row_weight_topk,
    sorted_unique_rows,
)
from otto_tpu.ops.sessions import distinct_recent_first, recency_weights

# event-type coefficients for the recency route (covisitation/inference.py:72)
RECENCY_TYPE_COEFF = (1.0, 9.0, 6.0)
FT_BONUS = {"clicks": 0.05, "carts": 0.05, "orders": 0.15}
COVISIT_BONUS = {"clicks": 0.05, "carts": 0.05, "orders": 0.15}


def session_unique_counts(store: EventStore) -> np.ndarray:
    """Exact distinct-aid count per session (vectorized host-side)."""
    order = np.lexsort((store.aid, store.session_idx))
    s = store.session_idx[order]
    a = store.aid[order]
    head = np.concatenate([[True], (s[1:] != s[:-1]) | (a[1:] != a[:-1])])
    return np.bincount(s[head], minlength=store.n_sessions).astype(np.int32)


def _concat_cols(*arrays):
    return jnp.concatenate(arrays, axis=1)


def _derive_mask_last(aids, lengths):
    """Right-padded packing (EventStore.pack keep='last'): valid columns are
    0..min(len,L)-1 and the last event sits at column min(len,L)-1.  Deriving
    these on device avoids shipping the bool mask to the device (0.5 MB per
    2048x256 chunk)."""
    L = aids.shape[1]
    clipped = jnp.minimum(lengths, L).astype(jnp.int32)
    mask = jnp.arange(L, dtype=jnp.int32)[None, :] < clipped[:, None]
    last = jnp.take_along_axis(aids, jnp.maximum(clipped - 1, 0)[:, None], axis=1)
    return mask, last


@partial(jax.jit, static_argnames=("uniq_cap",))
def _heur_lists(aids, types, lengths, uniq_cap: int):
    """Per-session source lists shared by both heuristic routes, as one
    medium-size program (the same granularity as the candidate generator's
    _session_lists — a single route-level jit wedges this platform's remote
    compiler, see DESIGN.md §3)."""
    mask, last_aid = _derive_mask_last(aids, lengths)
    uniq_recent = distinct_recent_first(aids, mask, k=uniq_cap)
    click_uniq = sorted_unique_rows(jnp.where(types == 0, aids, -1), mask, uniq_cap)
    clickcart = sorted_unique_rows(jnp.where(types <= 1, aids, -1), mask, uniq_cap)
    cartorder = sorted_unique_rows(jnp.where(types >= 1, aids, -1), mask, uniq_cap)
    return mask, last_aid, uniq_recent, click_uniq, clickcart, cartorder


@partial(jax.jit, static_argnames=("k",))
def _vote_cascade(vals, uniq_recent, stats_row, k: int):
    """Vote-count top-k, session-aid exclusion, compaction, and the
    reference's padding cascade (session aids -> covisit votes -> global
    frequency, inference.py:238-243) for one event type."""
    top, _ = row_weight_topk(vals, jnp.ones_like(vals, jnp.float32), vals >= 0, k)
    filtered = compact_rows(mask_members(top, uniq_recent))
    return concat_unique_cascade(uniq_recent[:, :k], filtered, stats_row, k)


def _covisit_route(
    aids, types, lengths, tables, stats_top, uniq_cap: int, narrow_k: int, k: int
):
    """Batched covisitation-vote route for one chunk of sessions.

    List concatenation order matches the reference exactly (it sets the
    Counter tie-break): time + click_w + cart_w + click_cart + cart_order +
    fasttext for clicks; time + cart_w + cart_order + fasttext for carts and
    orders (inference.py:215-236).  The fasttext neighbor list arrives via
    ``tables['fasttext']`` when an embedding model is attached.
    """
    _, last_aid, uniq_recent, _, clickcart, _ = _heur_lists(aids, types, lengths, uniq_cap)

    g_time = gather_neighbors(tables["time_weighted"][:, :narrow_k], uniq_recent)
    g_clickw = gather_neighbors(tables["click_weighted"][:, :narrow_k], clickcart)
    g_cartw = gather_neighbors(tables["cart_weighted"][:, :narrow_k], clickcart)
    g_clickcart = gather_neighbors(tables["click_cart"][:, :narrow_k], clickcart)
    g_cartorder = gather_neighbors(tables["cart_order"][:, :narrow_k], clickcart)
    fts = tables.get("fasttext")
    ft_list = (
        gather_neighbors(fts, last_aid)
        if fts is not None
        else jnp.full((aids.shape[0], 0), -1, jnp.int32)
    )

    lists = {
        "clicks": _concat_cols(g_time, g_clickw, g_cartw, g_clickcart, g_cartorder, ft_list),
        "carts": _concat_cols(g_time, g_cartw, g_cartorder, ft_list),
        "orders": _concat_cols(g_time, g_cartw, g_cartorder, ft_list),
    }
    out = {}
    for etype in EVENT_TYPES:
        out[etype] = _vote_cascade(
            lists[etype], uniq_recent, jnp.asarray(stats_top[etype])[:k], k
        )
    return out


def _recency_route(
    aids, types, lengths, tables, uniq_cap: int, narrow_k: int, k: int
):
    """Batched typed-recency route (inference.py:143-199): per-type log-recency
    weights x coefficients {1,9,6}, +bonus votes from fastText neighbors of the
    last aid and one covisitation table per type."""
    S = aids.shape[0]
    mask, last_aid, _, click_uniq, clickcart, cartorder = _heur_lists(
        aids, types, lengths, uniq_cap
    )

    fts = tables.get("fasttext")
    ft_list = (
        gather_neighbors(fts, last_aid)
        if fts is not None
        else jnp.full((S, 0), -1, jnp.int32)
    )

    bonus_lists = {
        "clicks": gather_neighbors(tables["time_weighted"][:, :narrow_k], click_uniq),
        "carts": gather_neighbors(tables["cart_weighted"][:, :narrow_k], clickcart),
        "orders": gather_neighbors(tables["cart_order"][:, :narrow_k], cartorder),
    }
    lo = {"clicks": 0.1, "carts": 0.5, "orders": 0.5}

    out = {}
    for etype in EVENT_TYPES:
        out[etype] = _recency_scored_top(
            aids, types, lengths, mask, ft_list, bonus_lists[etype],
            FT_BONUS[etype], COVISIT_BONUS[etype], lo[etype], k,
        )
    return out


@partial(jax.jit, static_argnames=("ft_bonus", "cv_bonus", "lo", "k"))
def _recency_scored_top(aids, types, lengths, mask, ft_list, bonus_list,
                        ft_bonus: float, cv_bonus: float, lo: float, k: int):
    """One event type of the recency route: log-recency event weights x type
    coefficients {1,9,6} plus flat neighbor bonuses, weighted multiset top-k."""
    L = aids.shape[1]
    clipped = jnp.sum(mask, axis=1)
    offset = (lengths - clipped)[:, None].astype(jnp.float32)
    true_pos = offset + jnp.arange(L, dtype=jnp.float32)[None, :]
    coeff = jnp.asarray(RECENCY_TYPE_COEFF, jnp.float32)[types]
    w_events = recency_weights(lengths, true_pos, mask, lo=lo, hi=1.0) * coeff
    ft_w = jnp.full(ft_list.shape, ft_bonus, jnp.float32)
    bl_w = jnp.full(bonus_list.shape, cv_bonus, jnp.float32)
    vals = _concat_cols(aids, ft_list, bonus_list)
    ws = _concat_cols(w_events, ft_w, bl_w)
    valid = _concat_cols(mask, ft_list >= 0, bonus_list >= 0)
    top, _ = row_weight_topk(vals, ws, valid, k)
    return top


def covisit_heuristic_predictions(
    store: EventStore,
    matrices: CovisitationMatrices,
    stats_top: dict[str, np.ndarray],
    ft_neighbors: np.ndarray | None = None,
    narrow_k: int = 15,
    k: int = TOP_K,
    max_len: int = 256,
    unique_cap: int = 64,
    chunk_sessions: int = 2048,
    mesh=None,
    recency_host_f64: bool = False,
    covisit_host: bool = False,
) -> dict[str, np.ndarray]:
    """Full heuristic recommender over all sessions of ``store``.

    ``recency_host_f64`` routes the >=20-unique-aid sessions through the
    vectorized host float64 accumulator
    (:mod:`otto_tpu.models.heuristic_host`) instead of the f32 device
    kernels — exact reference tie-break semantics (and the fast path on a
    CPU host).  ``covisit_host`` does the same for the covisitation-vote
    route (unit votes — exact by construction); with both set the whole
    heuristic serves host-side with no device dispatch.

    stats_top: per-type global top-20 aids (frequency fill).
    ft_neighbors: optional [n_aids, NN] nearest-neighbor table from the
    embedding model (replaces the reference's Annoy index; neighbors must
    already exclude the query aid itself).

    With ``mesh``, sessions shard over ``data`` and the narrow tables +
    kNN table shard row-wise over ``model``
    (:func:`otto_tpu.parallel.serving.make_sharded_heuristic_routes`)."""
    counts = session_unique_counts(store)
    packed = store.pack(max_len=max_len, keep="last")
    S = store.n_sessions

    with_ft = ft_neighbors is not None
    sharded = None
    if mesh is not None:
        from otto_tpu.parallel.serving import make_sharded_heuristic_routes, pad_table_rows

        msize = mesh.shape["model"]
        chunk_sessions = -(-chunk_sessions // mesh.shape["data"]) * mesh.shape["data"]
        narrow = {
            kind: jnp.asarray(pad_table_rows(t[0][:, :narrow_k], msize))
            for kind, t in matrices.tables.items()
        }
        ft_dev = (jnp.asarray(pad_table_rows(ft_neighbors, msize)) if with_ft
                  else jnp.zeros((msize, 1), jnp.int32))
        stats_rep = {e: jnp.asarray(stats_top[e][:k]) for e in EVENT_TYPES}
        # route factories per unique-cap (length buckets use narrower caps)
        _route_cache: dict[int, tuple] = {}

        def sharded(cap):
            if cap not in _route_cache:
                _route_cache[cap] = make_sharded_heuristic_routes(
                    mesh, cap, narrow_k, k, with_ft
                )
            return _route_cache[cap]

    tables = {kind: jnp.asarray(t[0]) for kind, t in matrices.tables.items()}
    if ft_neighbors is not None:
        tables["fasttext"] = jnp.asarray(ft_neighbors)
    stats_dev = {etype: jnp.asarray(stats_top[etype][:k]) for etype in EVENT_TYPES}

    # Each route runs as a handful of medium-size jitted programs per chunk
    # (_heur_lists + gathers + one vote/top-k program per event type).  Only
    # lengths/aids/types go to the device; the mask is derived there.
    preds = {etype: np.full((S, k), -1, np.int32) for etype in EVENT_TYPES}

    # Length-bucketed chunking: sessions whose (clipped) length fits in a
    # narrow width ship as [chunk, width] slices (the keep='last' layout is
    # left-aligned, so column-slicing is exact for them).  Most OTTO sessions
    # are short, so this cuts host->device bytes ~8x at the cost of one
    # extra compiled shape per op.
    widths = tuple(w for w in (32, packed.max_len) if w <= packed.max_len)

    def run_route(route_fn, idx, lookahead: int = 4):
        # dispatch lookahead: keep a few chunks in flight so device compute
        # overlaps host-link fetches (same pattern as build_covisitation)
        from collections import deque

        inflight = deque()

        def drain(item):
            res, sel = item
            for etype in EVENT_TYPES:
                preds[etype][sel] = np.asarray(res[etype])[: len(sel)]

        clens = np.minimum(store.lengths[idx], packed.max_len)
        lo = 0
        for width in widths:
            sub = idx[(clens > lo) & (clens <= width)]
            lo = width
            cap = min(unique_cap, width)
            for start in range(0, len(sub), chunk_sessions):
                sel = sub[start : start + chunk_sessions]
                pad = chunk_sessions - len(sel)
                sel_p = np.concatenate([sel, np.zeros(pad, np.int64)]) if pad else sel
                res = route_fn(
                    jnp.asarray(packed.aids[sel_p, :width]),
                    jnp.asarray(packed.types[sel_p, :width]),
                    jnp.asarray(np.minimum(packed.lengths[sel_p], width)
                                if width < packed.max_len else packed.lengths[sel_p]),
                    cap,
                )
                inflight.append((res, sel))
                if len(inflight) > lookahead:
                    drain(inflight.popleft())
        while inflight:
            drain(inflight.popleft())

    cov_idx = np.flatnonzero(counts < 20)
    rec_idx = np.flatnonzero(counts >= 20)
    log.info(
        "heuristic routing: %d covisitation, %d recency-weight sessions",
        len(cov_idx),
        len(rec_idx),
    )

    if sharded is not None:
        cov_fn = lambda a, t, lens, cap: sharded(cap)[0](
            a, t, lens, narrow["time_weighted"], narrow["click_weighted"],
            narrow["cart_weighted"], narrow["click_cart"], narrow["cart_order"],
            ft_dev, stats_rep["clicks"], stats_rep["carts"], stats_rep["orders"],
        )
        rec_fn = lambda a, t, lens, cap: sharded(cap)[1](
            a, t, lens, narrow["time_weighted"], narrow["cart_weighted"],
            narrow["cart_order"], ft_dev,
        )
    else:
        cov_fn = lambda a, t, lens, cap: _covisit_route(
            a, t, lens, tables, stats_dev, cap, narrow_k, k
        )
        rec_fn = lambda a, t, lens, cap: _recency_route(a, t, lens, tables, cap, narrow_k, k)

    if len(cov_idx):
        if covisit_host:
            from otto_tpu.models.heuristic_host import covisit_route_host

            narrow5 = {
                kind: np.asarray(matrices.tables[kind][0][:, :narrow_k])
                for kind in matrices.tables
            }
            host_cov = covisit_route_host(
                store, cov_idx, narrow5,
                {t: np.asarray(stats_top[t]) for t in EVENT_TYPES},
                ft_neighbors, k=k,
            )
            for etype in EVENT_TYPES:
                preds[etype][cov_idx] = host_cov[etype]
        else:
            run_route(cov_fn, cov_idx)
    if len(rec_idx):
        if recency_host_f64:
            from otto_tpu.models.heuristic_host import recency_route_host_f64

            narrow_np = {
                kind: np.asarray(matrices.tables[kind][0][:, :narrow_k])
                for kind in ("time_weighted", "cart_weighted", "cart_order")
            }
            host_preds = recency_route_host_f64(
                store, rec_idx, narrow_np, ft_neighbors, k=k
            )
            for etype in EVENT_TYPES:
                preds[etype][rec_idx] = host_preds[etype]
        else:
            run_route(rec_fn, rec_idx)
    return preds
