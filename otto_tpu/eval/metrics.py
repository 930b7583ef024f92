"""Recall@20 metrics as pure-JAX batched ops.

Semantics reproduced from the reference (src/metrics.py:4-61):

- **click recall**: membership of the single ground-truth click in the <=20
  predictions; sessions without a click label are excluded (NaN there).
- **cart/order recall**: ``tp / min(20, tp + fn)`` per session; sessions with
  no labels are excluded.
- **weighted recall@20** = 0.1*click + 0.3*cart + 0.6*order (e.g.
  src/baseline/aid_frequency.py:60).
- **corpus-level recall** (the ranker pipeline's variant,
  src/covisitation/inference.py:251-257): ``sum(hits) / sum(clip(|labels|, 0, 20))``.

Inputs are fixed-shape padded arrays — predictions ``[S, K]`` and labels
``[S, M]`` padded with ``-1`` — so everything jits to masked vector compares with
no ragged shapes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from otto_tpu import TYPE_WEIGHTS


@jax.jit
def hits_at_k(predictions: jax.Array, labels: jax.Array) -> jax.Array:
    """Per-session count of distinct label aids present in the predictions.

    predictions: int32 [S, K], padded with -1 (entries assumed distinct)
    labels:      int32 [S, M], padded with -1 (entries assumed distinct)
    returns:     int32 [S]
    """
    # [S, M, K] compare; padded entries (-1) never match because both sides
    # are masked independently.
    label_valid = labels >= 0
    pred_valid = predictions >= 0
    eq = (labels[:, :, None] == predictions[:, None, :]) & label_valid[:, :, None] & pred_valid[:, None, :]
    return jnp.sum(jnp.any(eq, axis=2), axis=1).astype(jnp.int32)


@jax.jit
def click_recall_at_k(predictions: jax.Array, click_label: jax.Array):
    """Mean click recall and the count of scored sessions.

    predictions: int32 [S, K] padded with -1
    click_label: int32 [S], -1 = no label (session excluded)
    """
    valid = click_label >= 0
    hit = jnp.any(predictions == click_label[:, None], axis=1) & valid
    n = jnp.sum(valid)
    recall = jnp.where(n > 0, jnp.sum(hit) / jnp.maximum(n, 1), jnp.nan)
    return recall, n


@partial(jax.jit, static_argnames=("k",))
def cart_order_recall_at_k(predictions: jax.Array, labels: jax.Array, k: int = 20):
    """Mean per-session ``tp / min(k, n_labels)`` recall and scored-session count."""
    n_labels = jnp.sum(labels >= 0, axis=1)
    hits = hits_at_k(predictions, labels)
    valid = n_labels > 0
    denom = jnp.minimum(k, n_labels)
    per_session = jnp.where(valid, hits / jnp.maximum(denom, 1), 0.0)
    n = jnp.sum(valid)
    recall = jnp.where(n > 0, jnp.sum(per_session) / jnp.maximum(n, 1), jnp.nan)
    return recall, n


@partial(jax.jit, static_argnames=("k",))
def corpus_recall_at_k(predictions: jax.Array, labels: jax.Array, k: int = 20) -> jax.Array:
    """Corpus-level recall: total hits over total clipped label counts."""
    n_labels = jnp.sum(labels >= 0, axis=1)
    hits = hits_at_k(predictions, labels)
    denom = jnp.sum(jnp.clip(n_labels, 0, k))
    return jnp.where(denom > 0, jnp.sum(hits) / jnp.maximum(denom, 1), jnp.nan)


def weighted_recall(click: float, cart: float, order: float) -> float:
    w_click, w_cart, w_order = TYPE_WEIGHTS
    return w_click * click + w_cart * cart + w_order * order


@partial(jax.jit, static_argnames=("k",))
def map_at_k(scores: jax.Array, labels: jax.Array, mask: jax.Array, k: int = 20) -> jax.Array:
    """Mean average precision @ k over per-session candidate lists — the
    reference GBDTs' training eval metric (models/lightgbm/config.yaml:94-96,
    ``map`` with ``eval_at: 20/50``).

    scores: float [S, C] (higher = ranked earlier; -inf for invalid),
    labels: {0,1} int [S, C], mask: bool [S, C].  Sessions with no positive
    candidates are excluded from the mean (LightGBM semantics).  Returns a
    scalar.
    """
    S, C = scores.shape
    kk = min(k, C)
    s = jnp.where(mask, scores, -jnp.inf)
    _, order = jax.lax.top_k(s, kk)  # [S, kk] candidate indices by rank
    rel = jnp.take_along_axis(jnp.where(mask, labels, 0).astype(jnp.float32), order, axis=1)
    ranks = jnp.arange(1, kk + 1, dtype=jnp.float32)[None, :]
    cum_rel = jnp.cumsum(rel, axis=1)
    precision_at_hit = (cum_rel / ranks) * rel
    n_pos = jnp.sum(jnp.where(mask, labels, 0), axis=1).astype(jnp.float32)
    denom = jnp.minimum(n_pos, float(kk))
    ap = jnp.where(denom > 0, jnp.sum(precision_at_hit, axis=1) / jnp.maximum(denom, 1.0), jnp.nan)
    return jnp.nanmean(ap)
