"""Histogram GBDT: binning, split search vs a numpy oracle,
lambdarank gradients vs autodiff, end-to-end ranking quality, and the k-fold
protocol + persistence (reference semantics: src/ranker/lgb_trainer.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from otto_tpu.config import GBDTConfig
from otto_tpu.models.gbdt import (
    GBDTRankerModel,
    _grow_tree,
    _lambdarank_gh,
    bin_features,
    fit_bin_edges,
    fit_gbdt,
    load_ranker_model,
    train_gbdt_ranker,
)
from otto_tpu.models.ranker import RankerData

SMALL = GBDTConfig(
    n_trees=30, early_stopping_rounds=1000, learning_rate=0.3, max_depth=3,
    n_bins=32, min_data_in_leaf=1, min_split_gain=0.0, min_child_weight=1e-6,
    subsample=1.0, colsample=1.0, n_folds=3, chunk_sessions=64,
)


def test_binning_monotone_and_missing(rng):
    x = rng.normal(size=(500, 4)).astype(np.float32)
    x[::7, 2] = np.nan
    edges = fit_bin_edges(x, n_bins=16)
    b = bin_features(x, edges)
    assert b.dtype == np.uint8
    assert (b[::7, 2] == 0).all()
    nn = ~np.isnan(x[:, 0])
    order = np.argsort(x[nn, 0])
    assert (np.diff(b[nn, 0][order].astype(int)) >= 0).all()
    assert b[nn, 0].min() >= 1 and b.max() <= 15


def _oracle_best_split(binned, g, h, n_bins, lam):
    """Brute-force the depth-1 split over every (feature, bin)."""
    N, F = binned.shape
    G, H = g.sum(), h.sum()
    parent = G * G / (H + lam)
    best = (-np.inf, 0, 0)
    for f in range(F):
        for b in range(n_bins - 1):
            left = binned[:, f] <= b
            if left.sum() == 0 or (~left).sum() == 0:
                continue
            GL, HL = g[left].sum(), h[left].sum()
            GR, HR = G - GL, H - HL
            gain = GL * GL / (HL + lam) + GR * GR / (HR + lam) - parent
            if gain > best[0]:
                best = (gain, f, b)
    return best


def test_grow_tree_matches_split_oracle(rng):
    N, F, n_bins, lam = 400, 5, 16, 0.01
    binned = rng.integers(1, n_bins, size=(N, F)).astype(np.uint8)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.uniform(0.1, 1.0, size=N).astype(np.float32)
    ones = jnp.ones(N, jnp.float32)
    feat, thr, leaf, gains, leaf_idx = _grow_tree(
        jnp.asarray(binned), jnp.asarray(g), jnp.asarray(h), ones, ones,
        jnp.ones(F, bool), jnp.float32(lam), jnp.float32(0.0),
        jnp.float32(1.0), jnp.float32(0.0), jnp.float32(1.0),
        depth=1, n_bins=n_bins, hist_chunk=1 << 18,
    )
    egain, ef, eb = _oracle_best_split(binned, g.astype(np.float64), h.astype(np.float64), n_bins, lam)
    assert int(feat[0]) == ef
    assert int(thr[0]) == eb
    assert float(gains[0]) == pytest.approx(egain, rel=1e-3)
    # leaf values: -G/(H+lam) over each side
    left = binned[:, ef] <= eb
    assert float(leaf[0]) == pytest.approx(-g[left].sum() / (h[left].sum() + lam), rel=1e-3)
    assert float(leaf[1]) == pytest.approx(-g[~left].sum() / (h[~left].sum() + lam), rel=1e-3)
    np.testing.assert_array_equal(np.asarray(leaf_idx), (~left).astype(np.int32))


def test_hist_chunking_equivalence(rng):
    N, F, n_bins = 300, 4, 16
    binned = jnp.asarray(rng.integers(0, n_bins, size=(N, F)).astype(np.uint8))
    g = jnp.asarray(rng.normal(size=N).astype(np.float32))
    h = jnp.asarray(rng.uniform(0.1, 1.0, size=N).astype(np.float32))
    ones = jnp.ones(N, jnp.float32)
    args = (binned, g, h, ones, ones, jnp.ones(F, bool),
            jnp.float32(0.01), jnp.float32(0.0), jnp.float32(1.0),
            jnp.float32(0.0), jnp.float32(0.5))
    a = _grow_tree(*args, depth=3, n_bins=n_bins, hist_chunk=1 << 18)
    b = _grow_tree(*args, depth=3, n_bins=n_bins, hist_chunk=64)  # forces scan path
    for xa, xb in zip(a, b):
        np.testing.assert_allclose(np.asarray(xa), np.asarray(xb), rtol=1e-5, atol=1e-6)


def test_mm_hist_matches_numpy(rng):
    from otto_tpu.models.gbdt import _mm_hist

    N, F, n_bins, K = 500, 6, 16, 4
    binned = rng.integers(0, n_bins, size=(N, F)).astype(np.uint8)
    key = rng.integers(0, K, size=N).astype(np.int32)
    vals = rng.normal(size=(N, 3)).astype(np.float32)
    got = np.asarray(_mm_hist(jnp.asarray(binned), jnp.asarray(key),
                              jnp.asarray(vals), K, n_bins, chunk=128))
    ref = np.zeros((K, F, n_bins, 3), np.float64)
    for r in range(N):
        for f in range(F):
            ref[key[r], f, binned[r, f]] += vals[r]
    # near-zero entries cancel (sums of ~N(0,1)); bound the absolute error
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_grow_tree_matmul_matches_scatter(rng):
    """The factored-matmul + sibling-subtraction histograms reproduce the
    scatter path's trees (same splits, same leaves) on random data."""
    N, F, n_bins = 600, 5, 16
    binned = jnp.asarray(rng.integers(0, n_bins, size=(N, F)).astype(np.uint8))
    g = jnp.asarray(rng.normal(size=N).astype(np.float32))
    h = jnp.asarray(rng.uniform(0.1, 1.0, size=N).astype(np.float32))
    ones = jnp.ones(N, jnp.float32)
    args = (binned, g, h, ones, ones, jnp.ones(F, bool),
            jnp.float32(0.01), jnp.float32(0.0), jnp.float32(1.0),
            jnp.float32(0.0), jnp.float32(0.5))
    a = _grow_tree(*args, depth=4, n_bins=n_bins, hist_chunk=1 << 18,
                   hist_impl="matmul")
    b = _grow_tree(*args, depth=4, n_bins=n_bins, hist_chunk=1 << 18,
                   hist_impl="scatter")
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))  # feats
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))  # thrs
    np.testing.assert_allclose(np.asarray(a[2]), np.asarray(b[2]),
                               rtol=1e-4, atol=1e-5)  # leaves
    np.testing.assert_array_equal(np.asarray(a[4]), np.asarray(b[4]))  # routing


def test_lambdarank_gh_matches_autodiff(rng):
    S, C = 6, 9
    scores = jnp.asarray(rng.normal(size=(S, C)).astype(np.float32))
    labels = jnp.asarray((rng.random((S, C)) < 0.3).astype(np.int8))
    mask = jnp.asarray(rng.random((S, C)) < 0.9)

    def loss(s):
        sm = jnp.where(mask, s, -1e30)
        order = jnp.argsort(-sm, axis=1)
        ranks = jnp.argsort(order, axis=1)
        disc_t = 1.0 / jnp.log2(jnp.arange(C, dtype=jnp.float32) + 2.0)
        disc = jnp.where(ranks < 20, disc_t[ranks], 0.0)
        lab = labels.astype(jnp.float32)
        pos_pair = (lab[:, :, None] > lab[:, None, :]) & mask[:, :, None] & mask[:, None, :]
        delta = jax.lax.stop_gradient(jnp.abs(disc[:, :, None] - disc[:, None, :]))
        pair = jax.nn.softplus(-(sm[:, :, None] - sm[:, None, :])) * delta
        return jnp.sum(jnp.where(pos_pair, pair, 0.0))

    g_auto = jax.grad(loss)(scores)
    g, h = _lambdarank_gh(scores, labels, mask, k=20, chunk=4, norm=False)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_auto), rtol=1e-4, atol=1e-5)
    assert (np.asarray(h) >= 0).all()
    # masked candidates get zero gradient
    assert np.abs(np.asarray(g)[~np.asarray(mask)]).max() == 0.0

    # norm=True (LightGBM's lambdarank_norm default) divides each session's
    # gradients by its ideal DCG@k — binary gains, positives stacked on top
    g_n, h_n = _lambdarank_gh(scores, labels, mask, k=20, chunk=4, norm=True)
    disc_t = 1.0 / np.log2(np.arange(C, dtype=np.float32) + 2.0)
    n_pos = np.asarray(((labels > 0) & np.asarray(mask)).sum(axis=1))
    ideal = np.cumsum(disc_t[:20])
    max_dcg = np.where(n_pos > 0, ideal[np.clip(np.minimum(n_pos, 20) - 1, 0, 19)], 1.0)
    np.testing.assert_allclose(
        np.asarray(g_n), np.asarray(g_auto) / max_dcg[:, None],
        rtol=1e-4, atol=1e-5)
    assert (np.asarray(h_n) >= 0).all()


def _listwise_problem(rng, S=240, C=16, F=6, noise=0.05):
    """Relevance is a noisy threshold on feature 0; other features are junk."""
    feats = rng.normal(size=(S, C, F)).astype(np.float32)
    rel = feats[..., 0] + noise * rng.normal(size=(S, C))
    labels = (rel > np.quantile(rel, 0.8, axis=1, keepdims=True)).astype(np.int8)
    mask = np.ones((S, C), bool)
    mask[:, -2:] = rng.random((S, 2)) < 0.7
    labels = labels & mask
    feats[~mask] = np.nan
    return feats, labels, mask


def test_gbdt_learns_listwise_ranking(rng):
    feats, labels, mask = _listwise_problem(rng)
    from otto_tpu.models.gbdt import fit_bin_edges as fbe

    edges = fbe(feats[mask], SMALL.n_bins)
    binned = bin_features(feats, edges)
    forest = fit_gbdt(binned, labels, mask, mask.astype(np.float32), SMALL)
    scores = forest.predict_binned(binned.reshape(-1, feats.shape[-1])).reshape(mask.shape)
    scores = np.where(mask, scores, -np.inf)
    # top-1 hit rate: the best-scored candidate should usually be a positive
    top1 = np.take_along_axis(labels, np.argmax(scores, axis=1)[:, None], axis=1)
    assert top1.mean() > 0.8
    # feature 0 dominates the gain importance
    assert int(np.argmax(forest.gain_importance)) == 0


def test_bce_objective_separable(rng):
    feats, labels, mask = _listwise_problem(rng, noise=0.0)
    cfg = SMALL.replace(loss="bce")
    edges = fit_bin_edges(feats[mask], cfg.n_bins)
    binned = bin_features(feats, edges)
    forest = fit_gbdt(binned, labels, mask, mask.astype(np.float32), cfg)
    scores = forest.predict_binned(binned.reshape(-1, feats.shape[-1])).reshape(mask.shape)
    pos = scores[mask & (labels > 0)]
    neg = scores[mask & (labels == 0)]
    assert np.median(pos) > np.median(neg) + 1.0
    assert forest.base != 0.0  # boost_from_average


def test_early_stopping_truncates(rng):
    feats, labels, mask = _listwise_problem(rng, S=120)
    cfg = SMALL.replace(n_trees=60, early_stopping_rounds=4, eval_every=2)
    edges = fit_bin_edges(feats[mask], cfg.n_bins)
    binned = bin_features(feats, edges)
    forest = fit_gbdt(
        binned[:80], labels[:80], mask[:80], mask[:80].astype(np.float32), cfg,
        val=(binned[80:], labels[80:], mask[80:]),
    )
    assert forest.feat.shape[0] == forest.best_iteration <= 60


def test_train_gbdt_ranker_protocol_and_persistence(rng, tmp_path):
    feats, labels, mask = _listwise_problem(rng, S=180, C=12)
    data = RankerData(
        features=feats, labels=labels, mask=mask,
        session_ids=np.arange(180), candidates=np.where(mask, 1, -1),
        feature_names=[f"f{i}" for i in range(feats.shape[-1])],
    )
    cfg = SMALL.replace(n_trees=15, n_folds=3)

    def eval_recall(idx, scores):
        top1 = np.take_along_axis(labels[idx], np.argmax(scores, axis=1)[:, None], 1)
        return float(top1.mean())

    model, oof = train_gbdt_ranker(data, cfg, eval_recall=eval_recall)
    assert len(model.forests) == 3
    assert len(model.fold_recalls) == 3
    assert np.isfinite(model.oof_recall)
    assert oof.shape == mask.shape
    assert (oof[~mask] == -np.inf).all()
    imp = model.feature_importance("gain")
    assert imp.shape == (feats.shape[-1],) and imp.sum() > 0

    p = tmp_path / "gbdt.npz"
    model.save(p)
    loaded = load_ranker_model(p)
    assert isinstance(loaded, GBDTRankerModel)
    np.testing.assert_allclose(
        loaded.predict(feats, mask), model.predict(feats, mask), rtol=1e-6
    )
    assert loaded.feature_names == data.feature_names


def test_dp_grow_tree_matches_single_device(rng):
    """Sharded histogram-psum growth produces the identical tree (the split
    search is deterministic given merged histograms)."""
    import jax.numpy as jnp
    from otto_tpu.config import MeshConfig
    from otto_tpu.models.gbdt import _grow_tree
    from otto_tpu.parallel import make_dp_gbdt_grow, make_mesh

    mesh = make_mesh(MeshConfig(data_parallel=4, model_parallel=2))
    N, F, n_bins = 512, 6, 16
    binned = jnp.asarray(rng.integers(0, n_bins, size=(N, F)).astype(np.uint8))
    g = jnp.asarray(rng.normal(size=N).astype(np.float32))
    h = jnp.asarray(rng.uniform(0.1, 1.0, size=N).astype(np.float32))
    ones = jnp.ones(N, jnp.float32)
    scalars = (jnp.float32(0.01), jnp.float32(0.0), jnp.float32(1.0),
               jnp.float32(0.0), jnp.float32(0.5))
    args = (binned, g, h, ones, ones, jnp.ones(F, bool), *scalars)
    single = _grow_tree(*args, depth=4, n_bins=n_bins, hist_chunk=1 << 18)
    dp = make_dp_gbdt_grow(mesh, depth=4, n_bins=n_bins)(*args)
    np.testing.assert_array_equal(np.asarray(single[0]), np.asarray(dp[0]))  # feats
    np.testing.assert_array_equal(np.asarray(single[1]), np.asarray(dp[1]))  # thrs
    np.testing.assert_allclose(np.asarray(single[2]), np.asarray(dp[2]), rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(single[4]), np.asarray(dp[4]))  # leaf ids


def test_fit_gbdt_data_parallel(rng):
    """Whole-forest data-parallel training (sessions sharded, trees identical
    on every device) reaches the same quality as single-device."""
    from otto_tpu.config import MeshConfig
    from otto_tpu.parallel import make_mesh

    mesh = make_mesh(MeshConfig(data_parallel=8, model_parallel=1))
    feats, labels, mask = _listwise_problem(rng, S=250)  # not divisible by 8: pads
    edges = fit_bin_edges(feats[mask], SMALL.n_bins)
    binned = bin_features(feats, edges)
    cfg = SMALL.replace(n_trees=20)
    forest = fit_gbdt(binned, labels, mask, mask.astype(np.float32), cfg, mesh=mesh)
    scores = forest.predict_binned(binned.reshape(-1, feats.shape[-1])).reshape(mask.shape)
    scores = np.where(mask, scores, -np.inf)
    top1 = np.take_along_axis(labels, np.argmax(scores, axis=1)[:, None], axis=1)
    assert top1.mean() > 0.8
