"""Wide-row multiset ops: sort-based per-row value counting and top-k.

The covisitation recommender concatenates per-session neighbor lists
(hundreds to thousands of entries) and takes ``Counter(...).most_common(k)``
(reference: src/covisitation/inference.py:227-236,
src/ranker/regular_candidate_generation.py:162-176).  The O(L^2) equality
kernel in :mod:`otto_tpu.ops.sessions` is quadratic in row width, so for these
wide rows we count by sorting instead: sort each row, detect run boundaries,
run-length-sum the weights, and rank by (weight desc, first-occurrence asc) —
the exact ``Counter.most_common`` ordering (stable w.r.t. first insertion).

All shapes static; everything vectorizes across the session axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from otto_tpu.ops.scan import run_totals

NEG = jnp.float32(-3.4e38)


@partial(jax.jit, static_argnames=("k",))
def row_weight_topk(values: jax.Array, weights: jax.Array, valid: jax.Array, k: int):
    """Per-row weighted multiset top-k.

    values: int32 [S, M] (entries < 0 or with valid=False are ignored)
    weights: float32 [S, M] per-entry votes (Counter semantics: all ones)
    valid: bool [S, M]
    returns (top_values int32 [S, k] padded -1, top_weights float32 [S, k])
    ordered by (summed weight desc, first-occurrence position asc).
    """
    S, M = values.shape
    ok = valid & (values >= 0)
    big = jnp.int32(2147483647)
    v = jnp.where(ok, values, big)
    pos = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32), (S, M))

    # sort rows by (value, position), carrying weights through as a sort
    # payload (one variadic sort in place of argsort + full-width gathers)
    sv, sp, sw = jax.lax.sort(
        (v, pos, jnp.where(ok, weights, 0.0)), dimension=1, num_keys=2
    )

    # run boundaries + precision-safe segmented run sums
    head = jnp.concatenate(
        [jnp.ones((S, 1), bool), sv[:, 1:] != sv[:, :-1]], axis=1
    )
    run_total = run_totals(sw, head, axis=1)

    # rank run heads by (weight desc, first-occurrence asc); non-heads and
    # sentinel runs sink to +inf.  Again payload-carrying variadic sort.
    valid_head = head & (sv < big)
    neg_rt = jnp.where(valid_head, -run_total, jnp.inf)
    neg_s, _, sv_s, rt_s = jax.lax.sort(
        (neg_rt, sp, sv, run_total), dimension=1, num_keys=2
    )
    live = jnp.isfinite(neg_s[:, :k])
    top_vals = jnp.where(live, sv_s[:, :k], -1)
    top_w = jnp.where(live, rt_s[:, :k], 0.0)
    return top_vals.astype(jnp.int32), top_w


@partial(jax.jit, static_argnames=("k",))
def row_count_topk(values: jax.Array, valid: jax.Array, k: int):
    """``Counter(values).most_common(k)`` per row (unit votes)."""
    return row_weight_topk(values, jnp.ones_like(values, jnp.float32), valid, k)


@jax.jit
def mask_members(candidates: jax.Array, members: jax.Array) -> jax.Array:
    """Set candidate entries that appear in ``members`` to -1.

    candidates: int32 [S, K] padded -1; members: int32 [S, U] padded -1.
    Mirrors ``if aid not in session_unique_aids`` filters
    (src/covisitation/inference.py:229)."""
    is_member = jnp.any(
        (candidates[:, :, None] == members[:, None, :]) & (members >= 0)[:, None, :],
        axis=2,
    )
    return jnp.where(is_member, -1, candidates)


@jax.jit
def compact_rows(arr: jax.Array) -> jax.Array:
    """Stable left-compaction of valid (>=0) entries, padding with -1."""
    S, K = arr.shape
    invalid = (arr < 0).astype(jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32), (S, K))
    _, _, out = jax.lax.sort((invalid, pos, arr), dimension=1, num_keys=2)
    return out


@partial(jax.jit, static_argnames=("k",))
def concat_unique_cascade(primary: jax.Array, secondary: jax.Array, filler: jax.Array, k: int):
    """The reference's prediction padding cascade
    (src/covisitation/inference.py:238-243):

    ``out = primary + secondary[: k - len(primary)]``, then
    ``out = out + filler[: k - len(out)]``  (no dedup between stages beyond
    what the caller already applied).

    primary [S, P] / secondary [S, Q] padded -1 (left-compacted);
    filler [k] global aids.  Returns [S, k] int32 padded -1.
    """
    S = primary.shape[0]
    n_p = jnp.sum(primary >= 0, axis=1)
    n_q = jnp.sum(secondary >= 0, axis=1)
    col = jnp.arange(k, dtype=jnp.int32)[None, :]

    # gather primary
    p_idx = jnp.clip(col, 0, primary.shape[1] - 1)
    from_p = jnp.take_along_axis(primary, p_idx, axis=1)
    use_p = col < n_p[:, None]

    q_col = col - n_p[:, None]
    q_idx = jnp.clip(q_col, 0, secondary.shape[1] - 1)
    from_q = jnp.take_along_axis(secondary, q_idx, axis=1)
    use_q = (~use_p) & (q_col < n_q[:, None])

    f_col = jnp.clip(col - n_p[:, None] - jnp.minimum(n_q, jnp.maximum(k - n_p, 0))[:, None], 0, k - 1)
    from_f = filler[f_col]

    out = jnp.where(use_p, from_p, jnp.where(use_q, from_q, from_f))
    return out.astype(jnp.int32)


@partial(jax.jit, static_argnames=("u",))
def sorted_unique_rows(values: jax.Array, valid: jax.Array, u: int):
    """Per-row ascending unique values (``np.unique`` semantics, reference's
    typed aid subsets — src/covisitation/inference.py:148-151), padded with -1
    to width ``u``."""
    S, M = values.shape
    big = jnp.int32(2147483647)
    v = jnp.where(valid & (values >= 0), values, big)
    sv = jnp.sort(v, axis=1)
    head = jnp.concatenate([jnp.ones((S, 1), bool), sv[:, 1:] != sv[:, :-1]], axis=1)
    keep = head & (sv < big)
    out = jnp.where(keep, sv, big)
    out = jnp.sort(out, axis=1)[:, :u]
    return jnp.where(out < big, out, -1).astype(jnp.int32)


@jax.jit
def gather_neighbors(table: jax.Array, queries: jax.Array) -> jax.Array:
    """Gather neighbor rows for per-session query aids.

    table: int32 [n_aids, K] padded -1; queries: int32 [S, U] padded -1.
    Returns int32 [S, U*K]: table[q] flattened per row, -1 where the query was
    padding.  Replaces the reference's per-aid dict lookups + list chaining
    (``itertools.chain(*[covisit[aid] for aid in ...])``)."""
    S, U = queries.shape
    safe_q = jnp.clip(queries, 0, table.shape[0] - 1)
    rows = table[safe_q]  # [S, U, K]
    rows = jnp.where((queries >= 0)[:, :, None], rows, -1)
    return rows.reshape(S, U * table.shape[1])
