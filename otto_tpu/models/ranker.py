"""Dense listwise scoring tower — the accelerator replacement for the LightGBM /
XGBoost lambdarank rerankers (reference: src/ranker/lgb_trainer.py,
xgb_trainer.py, models/lightgbm/config.yaml).

Instead of per-row GBDT inference over exploded candidate pickles, candidates
stay in their listwise shape ``[sessions, C, F]`` and a small MLP scores all
candidates of a batch of sessions in one matmul pass.  Losses:

- ``lambdarank``: pairwise logistic over within-session (pos, neg) pairs
  weighted by |delta-DCG@k| of swapping them — the LightGBM objective the
  reference fits (models/lightgbm/config.yaml lambdarank + MAP@20/50).
- ``listwise_softmax``: per-session cross-entropy of positives.
- ``bce``: pointwise binary.

The training protocol mirrors the reference's exactly:
5-fold GroupKFold by session (lgb_trainer.py:81-86), negative sampling ratio
0.30 restricted to sessions with >= 1 positive (:117-133), per-fold recall@20
on the held-out fold + OOF recall (:181-198), and fold-averaged test
prediction (:248-263).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax

from otto_tpu.config import RankerConfig
from otto_tpu.logging_utils import get_logger

log = get_logger(__name__)


# ------------------------------------------------------------------ folds
def group_kfold(session_sizes: np.ndarray, n_folds: int) -> np.ndarray:
    """sklearn-style GroupKFold: groups sorted by size descending, greedily
    assigned to the currently smallest fold.  Returns fold id per group."""
    order = np.argsort(-session_sizes, kind="stable")
    fold_sizes = np.zeros(n_folds, np.int64)
    fold_of = np.empty(len(session_sizes), np.int32)
    for g in order:
        f = int(np.argmin(fold_sizes))
        fold_of[g] = f
        fold_sizes[f] += session_sizes[g]
    return fold_of


# ------------------------------------------------------------------ model
def init_tower(key, n_features: int, hidden_dims, dtype=jnp.float32) -> dict:
    params = {}
    dims = [n_features, *hidden_dims, 1]
    for i in range(len(dims) - 1):
        key, sub = jax.random.split(key)
        scale = np.sqrt(2.0 / dims[i])
        params[f"w{i}"] = (jax.random.normal(sub, (dims[i], dims[i + 1])) * scale).astype(dtype)
        params[f"b{i}"] = jnp.zeros((dims[i + 1],), dtype)
    return params


def tower_forward(params, x, *, dropout_rate=0.0, key=None, compute_dtype=jnp.bfloat16):
    """x: [..., F] -> scores [...].  Matmuls run in bfloat16 on the matrix units with
    float32 accumulation."""
    h = x.astype(compute_dtype)
    n_layers = len([k for k in params if k.startswith("w")])
    for i in range(n_layers):
        w = params[f"w{i}"].astype(compute_dtype)
        h = jnp.dot(h, w, preferred_element_type=jnp.float32) + params[f"b{i}"].astype(jnp.float32)
        if i < n_layers - 1:
            h = jax.nn.relu(h)
            if dropout_rate > 0.0 and key is not None:
                key, sub = jax.random.split(key)
                keep = jax.random.bernoulli(sub, 1.0 - dropout_rate, h.shape)
                h = jnp.where(keep, h / (1.0 - dropout_rate), 0.0)
            h = h.astype(compute_dtype)
    return h[..., 0]


# ------------------------------------------------------------------ losses
def _dcg_discounts(C: int) -> jax.Array:
    return 1.0 / jnp.log2(jnp.arange(C, dtype=jnp.float32) + 2.0)


def lambdarank_loss(scores, labels, mask, k: int = 20):
    """Pairwise logistic weighted by |delta DCG@k| of swapping the pair.

    scores/labels/mask: [B, C].  Ranks come from the current scores; the
    discount difference of the two positions scales each pair's logistic
    loss (the LambdaMART weighting).
    """
    B, C = scores.shape
    neg_inf = jnp.float32(-1e30)
    s = jnp.where(mask, scores, neg_inf)
    # current rank of each candidate (0-based, by descending score)
    order = jnp.argsort(-s, axis=1)
    ranks = jnp.argsort(order, axis=1)
    disc = _dcg_discounts(C)
    disc_at = jnp.where(ranks < k, disc[jnp.clip(ranks, 0, C - 1)], 0.0)

    lab = labels.astype(jnp.float32)
    pos_pair = (lab[:, :, None] > lab[:, None, :]) & mask[:, :, None] & mask[:, None, :]
    sdiff = s[:, :, None] - s[:, None, :]
    delta = jnp.abs(disc_at[:, :, None] - disc_at[:, None, :])
    pair_loss = jax.nn.softplus(-sdiff) * delta
    total = jnp.sum(jnp.where(pos_pair, pair_loss, 0.0))
    n_pairs = jnp.maximum(jnp.sum(pos_pair), 1)
    return total / n_pairs


def listwise_softmax_loss(scores, labels, mask):
    neg_inf = jnp.float32(-1e30)
    s = jnp.where(mask, scores, neg_inf)
    logz = jax.nn.logsumexp(s, axis=1, keepdims=True)
    logp = s - logz
    lab = labels.astype(jnp.float32) * mask
    n_pos = jnp.sum(lab, axis=1)
    per_session = -jnp.sum(lab * logp, axis=1) / jnp.maximum(n_pos, 1)
    has_pos = n_pos > 0
    return jnp.sum(jnp.where(has_pos, per_session, 0.0)) / jnp.maximum(jnp.sum(has_pos), 1)


def bce_loss(scores, labels, mask):
    per = optax.sigmoid_binary_cross_entropy(scores, labels.astype(jnp.float32))
    return jnp.sum(jnp.where(mask, per, 0.0)) / jnp.maximum(jnp.sum(mask), 1)


LOSSES = {"lambdarank": lambdarank_loss, "listwise_softmax": listwise_softmax_loss, "bce": bce_loss}


# ------------------------------------------------------------------ trainer
@dataclass
class RankerData:
    """Listwise candidate features for ranking.

    features: float32 [S, C, F]; labels: int8 [S, C]; mask: bool [S, C];
    session_ids: [S]; candidates: int32 [S, C] (for emitting predictions).
    """

    features: np.ndarray
    labels: np.ndarray
    mask: np.ndarray
    session_ids: np.ndarray
    candidates: np.ndarray
    feature_names: list[str] = field(default_factory=list)


@dataclass
class FeatureNormalizer:
    """Standardizer with automatic signed-log1p compression of heavy-tailed
    columns.  GBDTs are invariant to monotone transforms; MLPs are not —
    count-like features spanning orders of magnitude crush the useful signal
    into a corner of the activation range without compression."""

    mean: np.ndarray
    std: np.ndarray
    log_cols: np.ndarray  # bool [F]

    @classmethod
    def fit(cls, features: np.ndarray, mask: np.ndarray,
            log_threshold: float = 50.0) -> "FeatureNormalizer":
        flat = features[mask].astype(np.float64)
        with np.errstate(invalid="ignore"):
            max_abs = np.nanmax(np.abs(flat), axis=0)
        log_cols = np.nan_to_num(max_abs) > log_threshold
        comp = flat.copy()
        comp[:, log_cols] = np.sign(comp[:, log_cols]) * np.log1p(np.abs(comp[:, log_cols]))
        mean = np.nanmean(comp, axis=0)
        std = np.nanstd(comp, axis=0)
        return cls(mean.astype(np.float32), np.maximum(std, 1e-6).astype(np.float32), log_cols)

    def __call__(self, features: np.ndarray) -> np.ndarray:
        out = np.asarray(features, np.float32).copy()
        lc = self.log_cols
        out[..., lc] = np.sign(out[..., lc]) * np.log1p(np.abs(out[..., lc]))
        out = (out - self.mean) / self.std
        return np.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0).astype(np.float32)


@dataclass
class RankerModel:
    params_per_fold: list[dict]
    normalizer: FeatureNormalizer
    config: RankerConfig
    feature_names: list[str] = field(default_factory=list)
    fold_recalls: list[float] = field(default_factory=list)
    oof_recall: float = float("nan")
    # candidate-rank prior blend weight selected at training time
    # (score = scaled_prior + prior_alpha * scaled_tower; nan = unused)
    prior_alpha: float = float("nan")

    def predict(self, features: np.ndarray, mask: np.ndarray, batch: int = 4096,
                mesh=None) -> np.ndarray:
        """Fold-averaged scores [S, C] (lgb_trainer.py:248-263 semantics).

        With ``mesh``, each batch is sharded over the mesh's ``data`` axis and
        all folds score in one program per batch (data-parallel serving; the
        reference predicts fold-by-fold over 20 file chunks on one device)."""
        x = self.normalizer(features)
        S = x.shape[0]
        out = np.zeros(x.shape[:2], np.float32)
        if mesh is not None:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P

            sharding = NamedSharding(mesh, P("data"))
            n_dev = mesh.devices.size
            batch = max(batch // n_dev, 1) * n_dev  # divisible batches
            for start in range(0, S, batch):
                end = min(start + batch, S)
                xb = x[start:end]
                pad = batch - (end - start)
                if pad:
                    xb = np.concatenate([xb, np.zeros((pad, *x.shape[1:]), x.dtype)])
                xb = jax.device_put(jnp.asarray(xb), sharding)
                s = np.asarray(_predict_folds_jit(tuple(self.params_per_fold), xb))
                out[start:end] = s[: end - start]
            return np.where(mask, out, -np.inf)
        for start in range(0, S, batch):
            xb = jnp.asarray(x[start : start + batch])
            acc = None
            for params in self.params_per_fold:
                s = np.asarray(_predict_jit(params, xb))
                acc = s if acc is None else acc + s
            out[start : start + batch] = acc / len(self.params_per_fold)
        return np.where(mask, out, -np.inf)

    def save(self, path):
        flat = {}
        for i, p in enumerate(self.params_per_fold):
            for k, v in p.items():
                flat[f"fold{i}_{k}"] = np.asarray(v)
        np.savez_compressed(
            path, __n_folds=len(self.params_per_fold),
            __mean=self.normalizer.mean, __std=self.normalizer.std,
            __logcols=self.normalizer.log_cols,
            __features=np.asarray(self.feature_names, dtype=object),
            __fold_recalls=np.asarray(self.fold_recalls, np.float64),
            __oof=np.float64(self.oof_recall),
            __prior_alpha=np.float64(self.prior_alpha),
            **flat,
        )

    @classmethod
    def load(cls, path, config: RankerConfig = RankerConfig()):
        z = np.load(path, allow_pickle=True)
        n = int(z["__n_folds"])
        params = []
        for i in range(n):
            prefix = f"fold{i}_"
            params.append(
                {k[len(prefix):]: jnp.asarray(z[k]) for k in z.files if k.startswith(prefix)}
            )
        return cls(
            params,
            FeatureNormalizer(z["__mean"], z["__std"], z["__logcols"]),
            config,
            feature_names=[str(f) for f in z["__features"]] if "__features" in z.files else [],
            fold_recalls=list(z["__fold_recalls"]) if "__fold_recalls" in z.files else [],
            oof_recall=float(z["__oof"]) if "__oof" in z.files else float("nan"),
            prior_alpha=float(z["__prior_alpha"]) if "__prior_alpha" in z.files else float("nan"),
        )


@jax.jit
def _predict_jit(params, x):
    return tower_forward(params, x, dropout_rate=0.0)


@jax.jit
def _predict_folds_jit(params_tuple, x):
    """All folds averaged in one program; with a data-sharded ``x`` XLA runs
    it data-parallel across the mesh (params replicate)."""
    acc = None
    for params in params_tuple:
        s = tower_forward(params, x, dropout_rate=0.0)
        acc = s if acc is None else acc + s
    return acc / len(params_tuple)


def negative_sample_mask(
    labels: np.ndarray, mask: np.ndarray, ratio: float, rng: np.random.Generator
) -> np.ndarray:
    """Training-candidate keep mask: all positives, plus ``ratio`` of the
    negatives in sessions that have at least one positive
    (lgb_trainer.py:117-133).  Sessions without positives are dropped."""
    has_pos = (labels * mask).sum(axis=1) > 0
    keep = mask & (labels > 0)
    negs = mask & (labels == 0) & has_pos[:, None]
    sampled = negs & (rng.random(labels.shape) < ratio)
    return keep | sampled


def train_ranker(
    data: RankerData,
    config: RankerConfig = RankerConfig(),
    eval_recall=None,
) -> tuple[RankerModel, np.ndarray]:
    """K-fold training; returns the model and OOF scores [S, C].

    ``eval_recall(session_indices, scores) -> float`` optionally computes
    recall@20 per fold (supplied by the pipeline so this module stays
    label-format agnostic)."""
    rng = np.random.default_rng(config.seed)
    S, C, F = data.features.shape
    normalizer = FeatureNormalizer.fit(data.features, data.mask)
    x_all = normalizer(data.features)

    sizes = data.mask.sum(axis=1)
    fold_of = group_kfold(sizes, config.n_folds)

    loss_fn = LOSSES[config.loss]
    schedule = optax.cosine_decay_schedule(config.learning_rate, 10_000, 0.1)
    optimizer = optax.adamw(schedule, weight_decay=config.weight_decay)
    B = config.batch_sessions

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, x, y, m, key):
        def f(p):
            scores = tower_forward(p, x, dropout_rate=config.dropout, key=key)
            return loss_fn(scores, y, m)

        loss, grads = jax.value_and_grad(f)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    oof = np.zeros((S, C), np.float32)
    params_per_fold = []
    fold_recalls = []
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

        key = jax.random.PRNGKey(config.seed + fold)
        key, init_key = jax.random.split(key)
        params = init_tower(init_key, F, config.hidden_dims)
        opt_state = optimizer.init(params)

        n_train = len(train_sessions)
        losses = []
        for epoch in range(config.epochs):
            order = rng.permutation(n_train)
            for i in range(max(n_train // B, 1)):
                sel = order[i * B : (i + 1) * B]
                if len(sel) < B:  # pad to fixed batch shape
                    sel = np.concatenate([sel, sel[: B - len(sel)]])
                sidx = train_sessions[sel]
                key, sub = jax.random.split(key)
                params, opt_state, l = step(
                    params,
                    opt_state,
                    jnp.asarray(x_all[sidx]),
                    jnp.asarray(data.labels[sidx]),
                    jnp.asarray(keep[sel]),
                    sub,
                )
                losses.append(float(l))
        # validation-fold scores
        for start in range(0, len(val_sessions), 4096):
            sl = val_sessions[start : start + 4096]
            oof[sl] = np.asarray(_predict_jit(params, jnp.asarray(x_all[sl])))
        params_per_fold.append(params)
        # MAP@20 on the held-out fold — the reference GBDTs' eval metric
        # (models/lightgbm/config.yaml:94-96)
        from otto_tpu.eval.metrics import map_at_k

        fold_map = float(map_at_k(
            jnp.asarray(oof[val_sessions]),
            jnp.asarray(data.labels[val_sessions].astype(np.int32)),
            jnp.asarray(data.mask[val_sessions]),
            k=20,
        ))
        if eval_recall is not None:
            r = eval_recall(val_sessions, np.where(data.mask[val_sessions], oof[val_sessions], -np.inf))
            fold_recalls.append(float(r))
            log.info("fold %d: loss %.4f recall@20 %.6f map@20 %.6f",
                     fold, np.mean(losses[-50:]), r, fold_map)
        else:
            log.info("fold %d: loss %.4f map@20 %.6f", fold, np.mean(losses[-50:]), fold_map)

    oof = np.where(data.mask, oof, -np.inf)
    model = RankerModel(params_per_fold, normalizer, config, data.feature_names, fold_recalls)
    if eval_recall is not None:
        model.oof_recall = float(eval_recall(np.arange(S), oof))
        log.info("OOF recall@20 %.6f", model.oof_recall)
    return model, oof


def top_k_predictions(candidates: np.ndarray, scores: np.ndarray, k: int = 20) -> np.ndarray:
    """Per-session top-k candidates by score: [S, C] -> [S, k] padded -1."""
    S, C = candidates.shape
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    rows = np.arange(S)[:, None]
    out = candidates[rows, order]
    picked_scores = scores[rows, order]
    return np.where(np.isfinite(picked_scores), out, -1).astype(np.int32)
