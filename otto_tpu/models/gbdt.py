"""Histogram gradient-boosted decision trees on the accelerator — the native replacement
for the reference's LightGBM/XGBoost lambdarank rerankers
(reference: src/ranker/lgb_trainer.py:134-165, src/ranker/xgb_trainer.py:139-166,
models/lightgbm/config.yaml).

The reference delegates its production ranking stage to two C++ GBDT engines.
This module re-implements the algorithm itself as XLA programs:

- **Quantile binning** (max_bin=255 + a reserved missing bin) on the host,
  features stored on device as one uint8 ``[rows, features]`` matrix.
- **Level-wise growth to a fixed depth** instead of LightGBM's leaf-wise
  growth: with ``max_depth=7`` a tree has the reference's ``num_leaves: 128``
  leaves, but every level is a fixed-shape program XLA compiles once —
  leaf-wise growth is data-dependent control flow an accelerator cannot pipeline.
- **Histogram build as one fused scatter-add per level**: the (grad, hess,
  count) triple scatters into a ``[nodes * features * bins, 3]`` accumulator;
  rows stream through a ``lax.scan`` in fixed-size chunks so the index tensor
  never materializes at full ``rows x features`` size.
- **Split search on device**: cumulative sums over bins give every (feature,
  bin) split's gain in one vectorized pass; ``feature_fraction`` is applied by
  masking gains (no data movement), ``bagging_fraction`` by zeroing sample
  weights.
- **LambdaRank gradients listwise**: candidates stay ``[sessions, C]``; the
  pairwise |delta-DCG@k|-weighted gradients/hessians for all sessions are one
  jitted ``lax.map`` over session chunks per boosting round.
- The reference's training protocol is kept exactly: 5-fold GroupKFold by
  session, 0.30 negative sampling in positive-bearing sessions
  (lgb_trainer.py:81-133), MAP@20 early stopping with 200-round patience
  (models/lightgbm/config.yaml:94-96,156-165), per-fold + OOF recall@20, and
  fold-averaged prediction (:248-263).  Gain/split feature importances match
  lgb_trainer.py:175-180.

Missing values (the feature tensor is full of NaN by construction — left-join
semantics in the feature families) get a reserved bin 0, which every split
sends left (LightGBM's ``zero_as_missing=false`` default direction is
learned; here it is fixed — documented divergence).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from otto_tpu.config import GBDTConfig
from otto_tpu.logging_utils import get_logger
from otto_tpu.models.ranker import RankerData, group_kfold, negative_sample_mask

log = get_logger(__name__)


# ----------------------------------------------------------------- binning
def fit_bin_edges(values: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature quantile bin edges from the finite entries of a flat
    ``[rows, F]`` sample.  Returns ``[F, n_bins - 2]`` (bin 0 is reserved for
    missing, so finite values land in bins ``1 .. n_bins - 1``)."""
    F = values.shape[1]
    n_edges = n_bins - 2
    edges = np.zeros((F, n_edges), np.float32)
    qs = np.linspace(0.0, 1.0, n_edges + 2)[1:-1]
    for f in range(F):
        col = values[:, f]
        col = col[np.isfinite(col)]
        if col.size == 0:
            edges[f] = 0.0
            continue
        e = np.unique(np.quantile(col, qs))
        edges[f, : len(e)] = e
        edges[f, len(e):] = e[-1] if len(e) else 0.0
        # pad with +inf so duplicate tail edges never create spurious bins
        if len(e) < n_edges:
            edges[f, len(e):] = np.float32(np.finfo(np.float32).max)
    return edges


def bin_features(values: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Digitize ``[..., F]`` float features into uint8 bins using ``edges``
    from :func:`fit_bin_edges`.  NaN -> bin 0; finite v -> 1 + #edges < v."""
    flat = values.reshape(-1, values.shape[-1])
    F = flat.shape[1]
    out = np.zeros(flat.shape, np.uint8)
    for f in range(F):
        col = flat[:, f]
        finite = ~np.isnan(col)
        b = 1 + np.searchsorted(edges[f], col[finite], side="left")
        out[finite, f] = b.astype(np.uint8)
    return out.reshape(values.shape)


# ----------------------------------------------------------------- grow
def _split_bf16_pair(a):
    """f32 -> (hi, lo) bf16 pair with hi + lo == a to ~2^-24.

    ``hi`` truncates the low 16 mantissa bits by integer masking — NOT via
    ``a - bf16(a).astype(f32)``, which XLA's allow-excess-precision pass
    may simplify to zero (the naive form then silently degrades to single
    bf16).  The masked ``hi`` is exactly representable in bf16 and
    ``lo = a - hi`` is exact in f32.
    """
    bits = lax.bitcast_convert_type(a, jnp.int32)
    hi = lax.bitcast_convert_type(bits & jnp.int32(-65536), jnp.float32)
    return hi.astype(jnp.bfloat16), (a - hi).astype(jnp.bfloat16)


def _mm_hist(binned, key, vals, n_keys: int, n_bins: int, chunk: int):
    """Histogram as a factored one-hot matmul instead of scatter-add.

    hist[k, f, b, c] = sum_r [key[r] == k] * [binned[r, f] == b] * vals[r, c]
    computed as ``A^T @ B`` with A[r, k*3+c] = onehot_key * vals (f32, split
    into a bf16 hi+lo pair) and B[r, f*n_bins+b] = onehot_bin (exact in
    bf16).  Both matmul dimensions are wide (3*n_keys x F*n_bins), so the
    product suits the matrix units.  Rows
    stream in ``chunk`` blocks through a ``lax.scan`` so the one-hot B tile
    never exceeds chunk * F * n_bins.

    binned: uint8 [N, F]; key: int32 [N] in [0, n_keys); vals: f32 [N, 3]
    (padding rows must carry zero vals).  Returns f32 [n_keys, F, n_bins, 3].
    """
    N, F = binned.shape
    iota_k = jnp.arange(n_keys, dtype=jnp.int32)
    iota_b = jnp.arange(n_bins, dtype=jnp.int32)

    def block(b_c, k_c, v_c):
        rows = b_c.shape[0]
        on = (k_c[:, None] == iota_k[None, :]).astype(jnp.float32)  # [C, K]
        a = (on[:, :, None] * v_c[:, None, :]).reshape(rows, n_keys * 3)
        hi, lo = _split_bf16_pair(a)
        b1h = (b_c[:, :, None] == iota_b[None, None, :]).astype(jnp.bfloat16)
        b1h = b1h.reshape(rows, F * n_bins)
        h = jnp.dot(hi.T, b1h, preferred_element_type=jnp.float32)
        h = h + jnp.dot(lo.T, b1h, preferred_element_type=jnp.float32)
        return h

    if N <= chunk:
        out = block(binned, key, vals)
    else:
        n_chunks = -(-N // chunk)
        pad = n_chunks * chunk - N
        b_p = jnp.pad(binned, ((0, pad), (0, 0)))
        k_p = jnp.pad(key, (0, pad))
        v_p = jnp.pad(vals, ((0, pad), (0, 0)))  # zero vals: no contribution

        def body(acc, ch):
            return acc + block(*ch), None

        out, _ = lax.scan(
            body,
            jnp.zeros((n_keys * 3, F * n_bins), jnp.float32),
            (
                b_p.reshape(n_chunks, chunk, F),
                k_p.reshape(n_chunks, chunk),
                v_p.reshape(n_chunks, chunk, 3),
            ),
        )
    return out.reshape(n_keys, 3, F, n_bins).transpose(0, 2, 3, 1)


def _grow_tree_impl(
    binned,  # uint8 [N, F]
    grad,  # f32 [N]
    hess,  # f32 [N]
    weight,  # f32 [N] (1 = usable training row, 0 = padding / sampled out)
    bag,  # f32 [N] (bagging keep mask for this tree)
    feat_mask,  # bool [F] (feature_fraction mask for this tree)
    reg_lambda,
    min_split_gain,
    min_data_in_leaf,
    min_child_weight,
    learning_rate,
    *,
    depth: int,
    n_bins: int,
    hist_chunk: int,
    axis_name: str | None = None,
    hist_impl: str = "matmul",
):
    """Grow one depth-``depth`` tree level-wise.  Returns level-order-
    concatenated split features/thresholds/gains (``2^depth - 1`` internal
    nodes: index of level-``l`` position ``p`` is ``2^l - 1 + p``), the
    lr-scaled leaf values ``[2^depth]``, and each row's final leaf id.

    With ``axis_name`` (under ``shard_map`` with rows sharded over that mesh
    axis) this becomes the classic data-parallel GBDT: each device builds
    local histograms, one ``psum`` per level merges them over the interconnect, split
    search runs redundantly (identical on every device), and rows route
    locally — the histogram is the only communication (bytes per level =
    ``nodes * features * bins * 3 * 4``, independent of row count)."""
    N, F = binned.shape
    lam = reg_lambda + 1e-12
    g = grad * bag
    h = hess * bag
    w = weight * bag
    vals = jnp.stack([g, h, w], axis=1)  # [N, 3]
    node = jnp.zeros(N, jnp.int32)
    col_off = (jnp.arange(F, dtype=jnp.int32) * n_bins)[None, :]
    feats, thrs, gains = [], [], []

    parent_hist = None
    for level in range(depth):
        n_nodes = 1 << level

        if hist_impl == "matmul":
            # Factored one-hot matmul (matrix units) + LightGBM's sibling subtraction:
            # build only the LEFT child's histogram from rows routed left;
            # the right sibling is parent - left (empty right children of
            # unsplit nodes come out exactly zero).  Halves the matmul work
            # and keeps every level's histogram on the matrix units.
            # cap the streaming chunk so the one-hot B tile (chunk * F *
            # n_bins bf16) stays a few hundred MB
            mm_chunk = min(hist_chunk, 1 << 14)
            if level == 0:
                hist = _mm_hist(binned, jnp.zeros_like(node), vals, 1,
                                n_bins, mm_chunk)
                if axis_name is not None:
                    hist = lax.psum(hist, axis_name)
            else:
                parent = node >> 1
                went_left = (node & 1) == 0
                left = _mm_hist(binned, parent,
                                vals * went_left[:, None].astype(jnp.float32),
                                n_nodes // 2, n_bins, mm_chunk)
                if axis_name is not None:
                    left = lax.psum(left, axis_name)
                right = parent_hist - left
                hist = jnp.stack([left, right], axis=1).reshape(
                    n_nodes, F, n_bins, 3
                )
        else:  # "scatter" — the naive XLA scatter-add path (kept as oracle)
            size = n_nodes * F * n_bins

            def hist_block(b_c, n_c, v_c):
                idx = n_c[:, None] * (F * n_bins) + col_off + b_c.astype(jnp.int32)
                v3 = jnp.broadcast_to(v_c[:, None, :], (*idx.shape, 3))
                return jnp.zeros((size, 3), jnp.float32).at[idx].add(v3)

            if N <= hist_chunk:
                hist = hist_block(binned, node, vals)
            else:
                n_chunks = -(-N // hist_chunk)
                pad = n_chunks * hist_chunk - N
                b_p = jnp.pad(binned, ((0, pad), (0, 0)))
                n_p = jnp.pad(node, (0, pad))
                v_p = jnp.pad(vals, ((0, pad), (0, 0)))  # zero grad/hess/weight

                def body(acc, chunk):
                    b_c, n_c, v_c = chunk
                    return acc + hist_block(b_c, n_c, v_c), None

                hist, _ = lax.scan(
                    body,
                    jnp.zeros((size, 3), jnp.float32),
                    (
                        b_p.reshape(n_chunks, hist_chunk, F),
                        n_p.reshape(n_chunks, hist_chunk),
                        v_p.reshape(n_chunks, hist_chunk, 3),
                    ),
                )

            if axis_name is not None:
                hist = lax.psum(hist, axis_name)
            hist = hist.reshape(n_nodes, F, n_bins, 3)
        parent_hist = hist
        cg = jnp.cumsum(hist[..., 0], axis=-1)
        ch = jnp.cumsum(hist[..., 1], axis=-1)
        cc = jnp.cumsum(hist[..., 2], axis=-1)
        G, H, C = cg[..., -1:], ch[..., -1:], cc[..., -1:]
        GL, HL, CL = cg, ch, cc
        GR, HR, CR = G - GL, H - HL, C - CL
        gain = GL**2 / (HL + lam) + GR**2 / (HR + lam) - G**2 / (H + lam)
        min_data = jnp.maximum(min_data_in_leaf, 1.0)
        valid = (
            (CL >= min_data)
            & (CR >= min_data)
            & (HL >= min_child_weight)
            & (HR >= min_child_weight)
            & feat_mask[None, :, None]
        )
        gain = jnp.where(valid, gain, -jnp.inf)
        flat = gain.reshape(n_nodes, F * n_bins)
        best = jnp.argmax(flat, axis=1)
        best_gain = jnp.max(flat, axis=1)
        ok = best_gain > min_split_gain
        bf = jnp.where(ok, (best // n_bins).astype(jnp.int32), 0)
        bb = jnp.where(ok, (best % n_bins).astype(jnp.int32), jnp.int32(n_bins))
        feats.append(bf)
        thrs.append(bb)
        gains.append(jnp.where(ok, best_gain, 0.0))

        fn = bf[node]
        bv = jnp.take_along_axis(binned, fn[:, None].astype(jnp.int32), axis=1)[:, 0]
        node = node * 2 + (bv.astype(jnp.int32) > bb[node]).astype(jnp.int32)

    n_leaves = 1 << depth
    lg = jnp.zeros(n_leaves, jnp.float32).at[node].add(g)
    lh = jnp.zeros(n_leaves, jnp.float32).at[node].add(h)
    if axis_name is not None:
        lg = lax.psum(lg, axis_name)
        lh = lax.psum(lh, axis_name)
    leaf = (-lg / (lh + lam)) * learning_rate
    return (
        jnp.concatenate(feats),
        jnp.concatenate(thrs),
        leaf,
        jnp.concatenate(gains),
        node,
    )


_grow_tree = jax.jit(
    _grow_tree_impl,
    static_argnames=("depth", "n_bins", "hist_chunk", "axis_name", "hist_impl"),
)


@partial(jax.jit, static_argnames=("depth",))
def _route_tree(binned, feat, thr, *, depth: int):
    """Final leaf id of every row under one tree (level-order arrays)."""
    N = binned.shape[0]
    pos = jnp.zeros(N, jnp.int32)
    for level in range(depth):
        i = (1 << level) - 1 + pos
        ff = feat[i]
        bv = jnp.take_along_axis(binned, ff[:, None], axis=1)[:, 0]
        pos = pos * 2 + (bv.astype(jnp.int32) > thr[i]).astype(jnp.int32)
    return pos


@partial(jax.jit, static_argnames=("depth",))
def _predict_forest(binned, feat, thr, leaf, base, *, depth: int):
    """Sum of all trees' (lr-scaled) leaf values: feat/thr [T, 2^depth - 1],
    leaf [T, 2^depth] -> scores [N]."""
    N = binned.shape[0]

    def tree_fn(pred, tree):
        f, t, lv = tree
        pos = jnp.zeros(N, jnp.int32)
        for level in range(depth):
            i = (1 << level) - 1 + pos
            ff = f[i]
            bv = jnp.take_along_axis(binned, ff[:, None], axis=1)[:, 0]
            pos = pos * 2 + (bv.astype(jnp.int32) > t[i]).astype(jnp.int32)
        return pred + lv[pos], None

    pred, _ = lax.scan(tree_fn, jnp.full(N, base, jnp.float32), (feat, thr, leaf))
    return pred


# ----------------------------------------------------------------- objectives
@partial(jax.jit, static_argnames=("k", "chunk", "norm"))
def _lambdarank_gh(scores, labels, mask, *, k: int = 20, chunk: int = 1024,
                   norm: bool = True):
    """LambdaRank gradients/hessians over listwise ``[S, C]`` groups.

    For each within-session pair (i, j) with label_i > label_j:
      rho  = sigmoid(s_j - s_i)
      g_i -= rho * |dDCG@k|;  g_j += rho * |dDCG@k|
      h   += rho * (1 - rho) * |dDCG@k|
    — the gradient/hessian of the pairwise-logistic lambdarank loss the
    reference's GBDTs minimize.  One jitted ``lax.map`` over session chunks.

    With ``norm`` (LightGBM's ``lambdarank_norm``, default true), |dDCG| is
    divided by the session's ideal DCG@k so every session contributes O(1)
    gradient mass regardless of its positive count — matching the reference
    tool's default behavior.
    """
    S, C = scores.shape
    pad = (-S) % chunk
    s_p = jnp.pad(scores, ((0, pad), (0, 0)))
    l_p = jnp.pad(labels.astype(jnp.float32), ((0, pad), (0, 0)))
    m_p = jnp.pad(mask, ((0, pad), (0, 0)))
    n_chunks = (S + pad) // chunk
    disc_table = 1.0 / jnp.log2(jnp.arange(C, dtype=jnp.float32) + 2.0)

    def one_chunk(args):
        s, lab, m = args
        sm = jnp.where(m, s, jnp.float32(-1e30))
        order = jnp.argsort(-sm, axis=1)
        ranks = jnp.argsort(order, axis=1)
        disc = jnp.where(ranks < k, disc_table[jnp.clip(ranks, 0, C - 1)], 0.0)
        pos_pair = (lab[:, :, None] > lab[:, None, :]) & m[:, :, None] & m[:, None, :]
        rho = jax.nn.sigmoid(sm[:, None, :] - sm[:, :, None])  # sigmoid(s_j - s_i)
        delta = jnp.abs(disc[:, :, None] - disc[:, None, :])
        if norm:
            # ideal DCG@k with binary gains: positives stacked at the top
            n_pos = jnp.sum((lab > 0) & m, axis=1)  # [chunk]
            ideal = jnp.cumsum(disc_table[:k])  # [k]
            idx = jnp.clip(jnp.minimum(n_pos, k) - 1, 0, k - 1)
            max_dcg = jnp.where(n_pos > 0, ideal[idx], 1.0)
            delta = delta / max_dcg[:, None, None]
        lam = jnp.where(pos_pair, rho * delta, 0.0)
        hc = jnp.where(pos_pair, rho * (1.0 - rho) * delta, 0.0)
        g = -jnp.sum(lam, axis=2) + jnp.sum(lam, axis=1)
        h = jnp.sum(hc, axis=2) + jnp.sum(hc, axis=1)
        return g, h

    g, h = lax.map(
        one_chunk,
        (
            s_p.reshape(n_chunks, chunk, C),
            l_p.reshape(n_chunks, chunk, C),
            m_p.reshape(n_chunks, chunk, C),
        ),
    )
    return g.reshape(-1, C)[:S], h.reshape(-1, C)[:S]


@jax.jit
def _bce_gh(scores, labels, mask):
    p = jax.nn.sigmoid(scores)
    g = jnp.where(mask, p - labels.astype(jnp.float32), 0.0)
    h = jnp.where(mask, p * (1.0 - p), 0.0)
    return g, h


# ----------------------------------------------------------------- forest fit
@dataclass
class GBDTForest:
    """One trained boosted forest (a single fold's model)."""

    feat: np.ndarray  # int32 [T, 2^depth - 1]
    thr: np.ndarray  # int32 [T, 2^depth - 1]
    leaf: np.ndarray  # float32 [T, 2^depth] (lr-scaled)
    base: float
    depth: int
    gain_importance: np.ndarray  # float64 [F]
    split_importance: np.ndarray  # int64 [F]
    best_iteration: int = 0

    def predict_binned(self, binned: np.ndarray, batch: int = 1 << 20,
                       device=None) -> np.ndarray:
        import jax

        put = (jnp.asarray if device is None
               else (lambda a: jax.device_put(jnp.asarray(a), device)))
        out = np.empty(binned.shape[0], np.float32)
        f = put(self.feat)
        t = put(self.thr)
        lv = put(self.leaf)
        for s in range(0, binned.shape[0], batch):
            xb = put(binned[s : s + batch])
            out[s : s + batch] = np.asarray(
                _predict_forest(xb, f, t, lv, jnp.float32(self.base), depth=self.depth)
            )
        return out


def fit_gbdt(
    binned: np.ndarray,  # uint8 [S, C, F] (listwise)
    labels: np.ndarray,  # int [S, C]
    mask: np.ndarray,  # bool [S, C] — candidate validity
    train_weight: np.ndarray,  # f32 [S, C] — 1 for rows kept for training
    config: GBDTConfig,
    *,
    val: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
    seed_offset: int = 0,
    mesh=None,
    data_axis: str = "data",
    device=None,
) -> GBDTForest:
    """Boost one forest over listwise candidate groups.

    ``val = (binned, labels, mask)`` enables MAP@20 early stopping with
    ``early_stopping_rounds`` patience (the reference's valid_sets +
    eval_at=[20] contract, lgb_trainer.py:156-165).

    With ``mesh`` the sessions shard over its ``data`` axis and every tree
    grows data-parallel (per-level histogram ``psum`` — see
    :func:`otto_tpu.parallel.data_parallel.make_dp_gbdt_grow`); the
    lambdarank gradient pass is per-session and shards with them."""
    from otto_tpu.eval.metrics import map_at_k

    S, C, F = binned.shape
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from otto_tpu.parallel.data_parallel import make_dp_gbdt_grow

        n_dp = mesh.shape[data_axis]
        pad_s = (-S) % n_dp
        if pad_s:
            binned = np.concatenate([binned, np.zeros((pad_s, C, F), binned.dtype)])
            labels = np.concatenate([labels, np.zeros((pad_s, C), labels.dtype)])
            mask = np.concatenate([mask, np.zeros((pad_s, C), bool)])
            train_weight = np.concatenate(
                [train_weight, np.zeros((pad_s, C), train_weight.dtype)]
            )
            S += pad_s
        row_sh = NamedSharding(mesh, P(data_axis))
        put = lambda a: jax.device_put(jnp.asarray(a), row_sh)  # noqa: E731
        grow = make_dp_gbdt_grow(
            mesh, depth=config.max_depth, n_bins=config.n_bins,
            hist_chunk=config.hist_rows_per_chunk, data_axis=data_axis,
            hist_impl=config.hist_impl,
        )
    else:
        # with ``device`` the training arrays are committed there and every
        # jitted pass (histograms, lambdarank gradients, ES metric) follows
        # them
        put = (jnp.asarray if device is None
               else (lambda a: jax.device_put(jnp.asarray(a), device)))
        grow = partial(
            _grow_tree, depth=config.max_depth, n_bins=config.n_bins,
            hist_chunk=config.hist_rows_per_chunk, hist_impl=config.hist_impl,
        )
    N = S * C
    flat = put(binned.reshape(N, F))
    lab_d = put(labels)
    mask_d = put(mask)
    w_d = put(train_weight)
    w_flat = w_d.reshape(N)
    keep_mask = w_d > 0  # pairs/pointwise terms use only kept rows

    depth, n_bins = config.max_depth, config.n_bins
    rng = np.random.default_rng(config.seed + seed_offset)
    key = jax.random.PRNGKey(config.seed + seed_offset)

    if config.loss == "bce":
        pos = float((labels * train_weight).sum())
        tot = float(train_weight.sum())
        p0 = min(max(pos / max(tot, 1.0), 1e-6), 1 - 1e-6)
        base = float(np.log(p0 / (1 - p0)))  # boost_from_average
    else:
        base = 0.0

    # non-mesh: commit via put so a ``device`` override routes the whole fit;
    # mesh: keep the original default placement (row-sharded puts are for the
    # flat training arrays only)
    vput = jnp.asarray if mesh is not None else put
    pred = vput(np.full((S, C), base, np.float32))
    if val is not None:
        vb, vl, vm = val
        Sv, Cv, _ = vb.shape
        vflat = vput(vb.reshape(Sv * Cv, F))
        vl_d = vput(vl.astype(np.int32))
        vm_d = vput(vm)
        val_pred = vput(np.full(Sv * Cv, base, np.float32))

    gain_imp = np.zeros(F, np.float64)
    split_imp = np.zeros(F, np.int64)
    feats_l, thrs_l, leaves_l = [], [], []
    best_metric, best_iter, since_best = -np.inf, 0, 0
    chunk = min(config.chunk_sessions, max(S, 1))

    if mesh is None and config.trees_per_call > 1:
        # ---- segmented path: scan trees_per_call whole trees per dispatch.
        # One host round-trip per SEGMENT (gradient pass, bagging, growth,
        # pred/val updates and the ES metric all stay on device).  Growth is
        # compute-bound at real data sizes, so this is off by default — it
        # pays only when dispatch latency rivals per-tree compute, and it
        # multiplies compile time by the segment length.
        n_take = max(int(round(config.colsample * F)), 1)

        def one_tree(carry, _):
            pred, val_pred, key = carry
            if config.loss == "lambdarank":
                g, h = _lambdarank_gh(pred, lab_d, keep_mask,
                                      k=config.lambdarank_k, chunk=chunk,
                                      norm=config.lambdarank_norm)
            else:
                g, h = _bce_gh(pred, lab_d, keep_mask)
            g = g.reshape(N) * w_flat
            h = h.reshape(N) * w_flat
            key, bkey, ckey = jax.random.split(key, 3)
            if config.subsample < 1.0:
                bag = (jax.random.uniform(bkey, (N,)) < config.subsample).astype(jnp.float32)
            else:
                bag = jnp.ones(N, jnp.float32)
            if config.colsample < 1.0:
                cols = jax.random.permutation(ckey, F)[:n_take]
                fm = jnp.zeros(F, bool).at[cols].set(True)
            else:
                fm = jnp.ones(F, bool)
            feat, thr, leaf, gains, leaf_idx = _grow_tree_impl(
                flat, g, h, w_flat, bag, fm,
                jnp.float32(config.reg_lambda), jnp.float32(config.min_split_gain),
                jnp.float32(config.min_data_in_leaf), jnp.float32(config.min_child_weight),
                jnp.float32(config.learning_rate),
                depth=depth, n_bins=n_bins, hist_chunk=config.hist_rows_per_chunk,
                hist_impl=config.hist_impl,
            )
            pred = pred + leaf[leaf_idx].reshape(S, C)
            if val is not None:
                vpos = _route_tree(vflat, feat, thr, depth=depth)
                val_pred = val_pred + leaf[vpos]
            return (pred, val_pred, key), (feat, thr, leaf, gains)

        @partial(jax.jit, static_argnames=("n_seg",), donate_argnums=(0, 1, 2))
        def boost_segment(pred, val_pred, key, n_seg: int):
            (pred, val_pred, key), trees = lax.scan(
                one_tree, (pred, val_pred, key), None, length=n_seg
            )
            if val is not None:
                vs = jnp.where(vm_d, val_pred.reshape(Sv, Cv), -jnp.inf)
                metric = map_at_k(vs, vl_d, vm_d, k=20)
            else:
                metric = jnp.float32(0.0)
            return pred, val_pred, key, trees, metric

        if val is None:
            val_pred = jnp.zeros((), jnp.float32)  # placeholder carry
        t = 0
        while t < config.n_trees:
            seg = min(config.trees_per_call, config.n_trees - t)
            pred, val_pred, key, (feat, thr, leaf, gains), metric = boost_segment(
                pred, val_pred, key, n_seg=seg
            )
            t += seg
            feat_h, gains_h = np.asarray(feat), np.asarray(gains)  # [seg, nodes]
            is_split = gains_h > 0
            np.add.at(gain_imp, feat_h[is_split], gains_h[is_split])
            np.add.at(split_imp, feat_h[is_split], 1)
            feats_l.extend(feat_h)
            thrs_l.extend(np.asarray(thr))
            leaves_l.extend(np.asarray(leaf))
            if val is not None:
                m = float(metric)
                if m > best_metric + 1e-9:
                    best_metric, best_iter, since_best = m, t, 0
                else:
                    since_best += seg
                if since_best >= config.early_stopping_rounds:
                    log.info("early stop at tree %d (best %d, MAP@20 %.6f)",
                             t, best_iter, best_metric)
                    break
        n_keep = best_iter if (val is not None and best_iter > 0) else len(feats_l)
        return GBDTForest(
            feat=np.stack(feats_l[:n_keep]).astype(np.int32),
            thr=np.stack(thrs_l[:n_keep]).astype(np.int32),
            leaf=np.stack(leaves_l[:n_keep]).astype(np.float32),
            base=base,
            depth=depth,
            gain_importance=gain_imp,
            split_importance=split_imp,
            best_iteration=n_keep,
        )

    for t in range(config.n_trees):
        if config.loss == "lambdarank":
            g, h = _lambdarank_gh(pred, lab_d, keep_mask, k=config.lambdarank_k,
                                  chunk=chunk, norm=config.lambdarank_norm)
        else:
            g, h = _bce_gh(pred, lab_d, keep_mask)
        g = g.reshape(N) * w_flat
        h = h.reshape(N) * w_flat

        key, bkey = jax.random.split(key)
        if config.subsample < 1.0:
            bag = (jax.random.uniform(bkey, (N,)) < config.subsample).astype(jnp.float32)
        else:
            bag = jnp.ones(N, jnp.float32)
        if config.colsample < 1.0:
            n_take = max(int(round(config.colsample * F)), 1)
            cols = rng.choice(F, size=n_take, replace=False)
            fm = np.zeros(F, bool)
            fm[cols] = True
        else:
            fm = np.ones(F, bool)

        feat, thr, leaf, gains, leaf_idx = grow(
            flat, g, h, w_flat, bag, jnp.asarray(fm),
            jnp.float32(config.reg_lambda), jnp.float32(config.min_split_gain),
            jnp.float32(config.min_data_in_leaf), jnp.float32(config.min_child_weight),
            jnp.float32(config.learning_rate),
        )
        pred = pred + leaf[leaf_idx].reshape(S, C)
        feat_h, gains_h = np.asarray(feat), np.asarray(gains)
        is_split = gains_h > 0
        np.add.at(gain_imp, feat_h[is_split], gains_h[is_split])
        np.add.at(split_imp, feat_h[is_split], 1)
        feats_l.append(feat_h)
        thrs_l.append(np.asarray(thr))
        leaves_l.append(np.asarray(leaf))

        if val is not None:
            vpos = _route_tree(vflat, feat, thr, depth=depth)
            val_pred = val_pred + leaf[vpos]
            if (t + 1) % config.eval_every == 0 or t == config.n_trees - 1:
                vs = jnp.where(vm_d, val_pred.reshape(Sv, Cv), -jnp.inf)
                metric = float(map_at_k(vs, vl_d, vm_d, k=20))
                if metric > best_metric + 1e-9:
                    best_metric, best_iter, since_best = metric, t + 1, 0
                else:
                    since_best += config.eval_every
                if since_best >= config.early_stopping_rounds:
                    log.info("early stop at tree %d (best %d, MAP@20 %.6f)",
                             t + 1, best_iter, best_metric)
                    break
    n_keep = best_iter if (val is not None and best_iter > 0) else len(feats_l)
    return GBDTForest(
        feat=np.stack(feats_l[:n_keep]).astype(np.int32),
        thr=np.stack(thrs_l[:n_keep]).astype(np.int32),
        leaf=np.stack(leaves_l[:n_keep]).astype(np.float32),
        base=base,
        depth=depth,
        gain_importance=gain_imp,
        split_importance=split_imp,
        best_iteration=n_keep,
    )


# ----------------------------------------------------------------- ranker API
@dataclass
class GBDTRankerModel:
    """K-fold GBDT ranker with the same serving surface as
    :class:`otto_tpu.models.ranker.RankerModel` (fold-averaged ``predict``,
    npz ``save``/``load``, ``prior_alpha``), so the two engines are
    interchangeable in the two-stage pipeline and the ensemble blend —
    the reference blends LightGBM and XGBoost this way
    (ranker/inference.py:64-85)."""

    forests: list[GBDTForest]
    edges: np.ndarray  # [F, n_bins - 2]
    config: GBDTConfig
    feature_names: list[str] = field(default_factory=list)
    fold_recalls: list[float] = field(default_factory=list)
    oof_recall: float = float("nan")
    prior_alpha: float = float("nan")

    def feature_importance(self, kind: str = "gain") -> np.ndarray:
        """Summed across folds (lgb_trainer.py:175-180 gain/split)."""
        attr = "gain_importance" if kind == "gain" else "split_importance"
        return np.sum([getattr(f, attr) for f in self.forests], axis=0)

    def predict(self, features: np.ndarray, mask: np.ndarray,
                batch: int = 1 << 20, mesh=None, device=None) -> np.ndarray:
        """Fold-averaged scores [S, C] (lgb_trainer.py:248-263 semantics).

        Device-resident fold loop: each binned chunk crosses the
        host->device link ONCE and all fold forests route it while it is
        resident (the reference reloads fold boosters around an in-RAM
        chunk, lgb_trainer.py:248-263; the per-fold re-transfer the naive
        port would pay is the VERDICT r3 item-7 17.5k rows/s bottleneck).
        ``device`` routes the forest pass to a specific jax device
        (committed inputs pin the jitted program to their device)."""
        S, C, F = features.shape
        binned = bin_features(features, self.edges).reshape(S * C, F)
        scores = self.predict_binned_folds(
            binned, batch=batch, device=device).reshape(S, C)
        return np.where(mask, scores, -np.inf)

    def predict_binned_folds(self, binned: np.ndarray,
                             batch: int = 1 << 20, device=None) -> np.ndarray:
        """Fold-averaged scores [N] for a pre-binned uint8 [N, F] matrix.

        Tree parameters are moved to the device once and stay resident
        across all chunks; chunk tails are padded to the batch shape so
        every dispatch reuses one compiled program."""
        import jax

        put = (jax.device_put if device is None
               else (lambda a: jax.device_put(a, device)))
        N = binned.shape[0]
        batch = max(1, min(batch, N))
        dev = [(put(f.feat), put(f.thr), put(f.leaf),
                jnp.float32(f.base), f.depth) for f in self.forests]
        out = np.empty(N, np.float32)
        inv = np.float32(1.0 / len(self.forests))
        for s in range(0, N, batch):
            chunk = binned[s : s + batch]
            n = chunk.shape[0]
            if n < batch:
                chunk = np.concatenate(
                    [chunk, np.zeros((batch - n, chunk.shape[1]), chunk.dtype)]
                )
            xb = put(chunk)
            acc = None
            for f, t, lv, b, d in dev:
                r = _predict_forest(xb, f, t, lv, b, depth=d)
                acc = r if acc is None else acc + r
            out[s : s + n] = np.asarray(acc)[:n]
        out *= inv
        return out

    def save(self, path) -> None:
        flat = {}
        for i, f in enumerate(self.forests):
            flat[f"fold{i}_feat"] = f.feat
            flat[f"fold{i}_thr"] = f.thr
            flat[f"fold{i}_leaf"] = f.leaf
            flat[f"fold{i}_meta"] = np.asarray([f.base, f.depth, f.best_iteration])
            flat[f"fold{i}_gain"] = f.gain_importance
            flat[f"fold{i}_split"] = f.split_importance
        np.savez_compressed(
            path, __gbdt=np.int64(1), __n_folds=len(self.forests),
            __edges=self.edges,
            __config=np.frombuffer(self.config.to_json().encode(), np.uint8),
            __features=np.asarray(self.feature_names, dtype=object),
            __fold_recalls=np.asarray(self.fold_recalls, np.float64),
            __oof=np.float64(self.oof_recall),
            __prior_alpha=np.float64(self.prior_alpha),
            **flat,
        )

    @classmethod
    def load(cls, path) -> "GBDTRankerModel":
        import json

        z = np.load(path, allow_pickle=True)
        config = GBDTConfig.from_dict(json.loads(bytes(z["__config"]).decode()))
        forests = []
        for i in range(int(z["__n_folds"])):
            base, depth, best = z[f"fold{i}_meta"]
            forests.append(GBDTForest(
                feat=z[f"fold{i}_feat"], thr=z[f"fold{i}_thr"], leaf=z[f"fold{i}_leaf"],
                base=float(base), depth=int(depth),
                gain_importance=z[f"fold{i}_gain"], split_importance=z[f"fold{i}_split"],
                best_iteration=int(best),
            ))
        return cls(
            forests, z["__edges"], config,
            feature_names=[str(f) for f in z["__features"]],
            fold_recalls=list(z["__fold_recalls"]),
            oof_recall=float(z["__oof"]),
            prior_alpha=float(z["__prior_alpha"]),
        )


def train_gbdt_ranker(
    data: RankerData,
    config: GBDTConfig = GBDTConfig(),
    eval_recall=None,
    mesh=None,
    device=None,
) -> tuple[GBDTRankerModel, np.ndarray]:
    """K-fold GBDT training with the reference's exact protocol; returns the
    model and OOF scores [S, C] (mirrors
    :func:`otto_tpu.models.ranker.train_ranker`).  With ``mesh`` each fold
    trains data-parallel over the mesh's ``data`` axis."""
    rng = np.random.default_rng(config.seed)
    S, C, F = data.features.shape
    edges = fit_bin_edges(data.features[data.mask], config.n_bins)
    binned = bin_features(data.features, edges)

    fold_of = group_kfold(data.mask.sum(axis=1), config.n_folds)
    oof = np.zeros((S, C), np.float32)
    forests, fold_recalls = [], []
    for fold in range(config.n_folds):
        val_sessions = np.flatnonzero(fold_of == fold)
        train_sessions = np.flatnonzero(fold_of != fold)
        keep = negative_sample_mask(
            data.labels[train_sessions], data.mask[train_sessions],
            config.negative_sampling_ratio, rng,
        )
        usable = keep.sum(axis=1) > 0
        train_sessions = train_sessions[usable]
        keep = keep[usable]

        forest = fit_gbdt(
            binned[train_sessions], data.labels[train_sessions],
            data.mask[train_sessions], keep.astype(np.float32), config,
            val=(binned[val_sessions], data.labels[val_sessions], data.mask[val_sessions]),
            seed_offset=fold,
            mesh=mesh,
            device=device,
        )
        forests.append(forest)
        vb = binned[val_sessions].reshape(-1, F)
        oof[val_sessions] = forest.predict_binned(
            vb, device=device).reshape(len(val_sessions), C)
        if eval_recall is not None:
            r = eval_recall(
                val_sessions,
                np.where(data.mask[val_sessions], oof[val_sessions], -np.inf),
            )
            fold_recalls.append(float(r))
            log.info("gbdt fold %d: %d trees, recall@20 %.6f",
                     fold, forest.best_iteration, r)

    oof = np.where(data.mask, oof, -np.inf)
    model = GBDTRankerModel(forests, edges, config, list(data.feature_names), fold_recalls)
    if eval_recall is not None:
        model.oof_recall = float(eval_recall(np.arange(S), oof))
        log.info("gbdt OOF recall@20 %.6f", model.oof_recall)
    return model, oof


def load_ranker_model(path, tower_config=None):
    """Load either ranker engine from an npz (dispatch on the __gbdt marker)."""
    from otto_tpu.config import RankerConfig
    from otto_tpu.models.ranker import RankerModel

    z = np.load(path, allow_pickle=True)
    is_gbdt = "__gbdt" in z.files
    z.close()
    if is_gbdt:
        return GBDTRankerModel.load(path)
    return RankerModel.load(path, tower_config or RankerConfig())
