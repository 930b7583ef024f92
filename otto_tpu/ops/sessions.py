"""Batched fixed-shape session kernels.

Every reference model iterates Python dicts per session:

- ``list(dict.fromkeys(aids[::-1]))`` — distinct aids, most-recent first
  (src/covisitation/inference.py:147)
- ``list(Counter(aids).keys())[:20]`` — distinct aids in first-seen order
  (src/baseline/aid_frequency.py:46)
- ``np.logspace(0.1, 1, n, base=2) - 1`` recency weights x per-type
  coefficients summed per aid, ranked descending
  (src/baseline/aid_weight.py:40-46, src/covisitation/inference.py:152-163)

Here each becomes a masked O(L^2) comparison kernel over packed ``[S, L]``
arrays: the pairwise aid-equality matrix is computed once and reused for
first/last-occurrence detection and per-aid weight aggregation.  L is the
(bucketed) max session length, so XLA sees only static shapes and fuses the
whole thing into a handful of vector loops.  Ties are broken exactly like the
reference: ``Counter.most_common`` / ``sorted`` are stable w.r.t. first
insertion, i.e. first-occurrence position ascending.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

NEG = jnp.float32(-3.4e38)


def _eq_matrix(aids: jax.Array, mask: jax.Array) -> jax.Array:
    """[S, L, L] pairwise equality, masked to valid positions."""
    eq = aids[:, :, None] == aids[:, None, :]
    valid = mask[:, :, None] & mask[:, None, :]
    return eq & valid


@jax.jit
def first_occurrence(aids: jax.Array, mask: jax.Array) -> jax.Array:
    """Bool [S, L]: True where this position is the first occurrence of its aid."""
    eq = _eq_matrix(aids, mask)
    L = aids.shape[1]
    earlier = jnp.tril(jnp.ones((L, L), dtype=bool), k=-1)
    dup = jnp.any(eq & earlier[None], axis=2)
    return mask & ~dup


@jax.jit
def last_occurrence(aids: jax.Array, mask: jax.Array) -> jax.Array:
    """Bool [S, L]: True where this position is the last occurrence of its aid."""
    eq = _eq_matrix(aids, mask)
    L = aids.shape[1]
    later = jnp.triu(jnp.ones((L, L), dtype=bool), k=1)
    dup = jnp.any(eq & later[None], axis=2)
    return mask & ~dup


def _rank_select(aids: jax.Array, score: jax.Array, tie_pos: jax.Array, k: int):
    """Top-k aids by (score desc, tie_pos asc). Returns ([S,k] aids padded -1,
    [S,k] scores padded NEG)."""
    # variadic sort ascending by (-score, tie_pos), carrying aids and scores
    # as payloads (argsort + take_along_axis lane-gathers are ~40x slower)
    _, _, picked, picked_score = jax.lax.sort(
        (-score, tie_pos, aids, score), dimension=1, num_keys=2
    )
    picked, picked_score = picked[:, :k], picked_score[:, :k]
    picked = jnp.where(picked_score > NEG / 2, picked, -1)
    return picked.astype(jnp.int32), picked_score


@partial(jax.jit, static_argnames=("k",))
def distinct_recent_first(aids: jax.Array, mask: jax.Array, k: int = 20):
    """Distinct session aids ordered most-recent-last-occurrence first —
    ``list(dict.fromkeys(aids[::-1]))[:k]``.  Returns [S, k] padded with -1."""
    last = last_occurrence(aids, mask)
    L = aids.shape[1]
    pos = jnp.arange(L, dtype=jnp.float32)[None, :]
    score = jnp.where(last, pos, NEG)
    picked, _ = _rank_select(aids, score, -pos[0][None, :].repeat(aids.shape[0], 0), k)
    return picked


@partial(jax.jit, static_argnames=("k",))
def distinct_first_seen(aids: jax.Array, mask: jax.Array, k: int = 20):
    """Distinct session aids in first-seen order — ``list(Counter(a).keys())[:k]``.
    Returns [S, k] padded with -1."""
    first = first_occurrence(aids, mask)
    L = aids.shape[1]
    pos = jnp.arange(L, dtype=jnp.float32)[None, :]
    score = jnp.where(first, -pos, NEG)
    picked, _ = _rank_select(aids, score, pos.repeat(aids.shape[0], 0), k)
    return picked


def recency_weights(lengths: jax.Array, true_pos: jax.Array, mask: jax.Array,
                    lo: float = 0.1, hi: float = 1.0) -> jax.Array:
    """``np.logspace(lo, hi, n, base=2) - 1`` evaluated at each event's true
    position (src/baseline/aid_weight.py:40).  For n == 1 the reference's
    logspace yields the single value 2^lo - 1... actually numpy's logspace with
    num=1 returns [2^lo]; we reproduce that: weight = 2^lo - 1."""
    n = jnp.maximum(lengths[:, None].astype(jnp.float32), 1.0)
    frac = jnp.where(n > 1, true_pos / jnp.maximum(n - 1.0, 1.0), 0.0)
    w = jnp.exp2(lo + (hi - lo) * frac) - 1.0
    return jnp.where(mask, w, 0.0)


@partial(jax.jit, static_argnames=("k", "lo", "hi"))
def recency_weighted_top_aids(
    aids: jax.Array,
    types: jax.Array,
    mask: jax.Array,
    lengths: jax.Array,
    type_coefficients: jax.Array,
    k: int = 20,
    lo: float = 0.1,
    hi: float = 1.0,
):
    """The aid-weight model (src/baseline/aid_weight.py:34-46): per-aid sum of
    recency weight x type coefficient, ranked descending with first-insertion
    tie-break.  Supports packed tails (keep='last'): the true event position is
    reconstructed from the clip offset.  Returns ([S,k] aids, [S,k] weights).
    """
    S, L = aids.shape
    clipped = jnp.sum(mask, axis=1)
    offset = (lengths - clipped)[:, None].astype(jnp.float32)  # events dropped from the front
    col = jnp.arange(L, dtype=jnp.float32)[None, :]
    true_pos = offset + col
    w = recency_weights(lengths, true_pos, mask, lo=lo, hi=hi)
    w = w * type_coefficients[types]

    eq = _eq_matrix(aids, mask)
    agg = jnp.einsum("sij,sj->si", eq.astype(jnp.float32), w)

    first = first_occurrence(aids, mask)
    # first-occurrence position of each aid (for the stable tie-break)
    L_pos = jnp.arange(L, dtype=jnp.float32)[None, :]
    big = jnp.float32(L)
    first_pos_per_pos = jnp.min(
        jnp.where(eq, L_pos[:, None, :], big), axis=2
    )
    score = jnp.where(first, agg, NEG)
    return _rank_select(aids, score, first_pos_per_pos, k)


@partial(jax.jit, static_argnames=("k",))
def per_aid_weight_top(
    aids: jax.Array,
    weights: jax.Array,
    mask: jax.Array,
    k: int = 20,
):
    """Generic per-aid weight aggregation + top-k (the Counter pattern):
    sums ``weights`` over equal aids, ranks descending, first-insertion
    tie-break.  Returns ([S,k] aids padded -1, [S,k] summed weights)."""
    eq = _eq_matrix(aids, mask)
    agg = jnp.einsum("sij,sj->si", eq.astype(jnp.float32), jnp.where(mask, weights, 0.0))
    first = first_occurrence(aids, mask)
    L = aids.shape[1]
    L_pos = jnp.arange(L, dtype=jnp.float32)[None, :]
    first_pos = jnp.min(jnp.where(eq, L_pos[:, None, :], jnp.float32(L)), axis=2)
    score = jnp.where(first, agg, NEG)
    return _rank_select(aids, score, first_pos, k)
