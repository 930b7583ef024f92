"""Retrieval (Annoy replacement) tests vs numpy brute force."""

import jax.numpy as jnp
import numpy as np
import pytest

import otto_tpu.ops.retrieval as R
from otto_tpu.ops.retrieval import build_neighbor_table, topk_blocked, topk_scan


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_topk_scan_matches_bruteforce(metric):
    rng = np.random.default_rng(0)
    items = rng.normal(size=(1000, 32)).astype(np.float32)
    q = rng.normal(size=(17, 32)).astype(np.float32)
    s, i = topk_scan(q, items, k=10, block=128, metric=metric)
    s, i = np.asarray(s), np.asarray(i)
    if metric == "dot":
        full = q @ items.T
    else:
        full = 2 * q @ items.T - np.sum(items**2, axis=1)[None, :]
    exp_i = np.argsort(-full, axis=1, kind="stable")[:, :10]
    # scores must match exactly; indices may differ only on exact ties
    np.testing.assert_allclose(s, np.take_along_axis(full, exp_i, axis=1), rtol=1e-4, atol=1e-5)
    same = (i == exp_i).mean()
    assert same > 0.99


def test_topk_scan_block_bigger_than_n():
    rng = np.random.default_rng(1)
    items = rng.normal(size=(37, 8)).astype(np.float32)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    s, i = topk_scan(q, items, k=5, block=64, metric="dot")
    full = q @ items.T
    exp_i = np.argsort(-full, axis=1)[:, :5]
    np.testing.assert_allclose(np.asarray(s), np.take_along_axis(full, exp_i, axis=1), rtol=1e-4, atol=1e-5)
    assert np.asarray(i).max() < 37


def test_neighbor_table_excludes_self():
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(300, 16)).astype(np.float32)
    table = build_neighbor_table(emb, k=5, metric="euclidean", query_batch=64, block=128)
    assert table.shape == (300, 5)
    for r in range(300):
        assert r not in table[r]
    # euclidean nearest neighbor check on a few rows
    for r in range(0, 300, 37):
        d = np.sum((emb - emb[r]) ** 2, axis=1)
        d[r] = np.inf
        assert table[r, 0] == np.argmin(d)


def test_neighbor_table_with_scores():
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(100, 8)).astype(np.float32)
    table, scores = build_neighbor_table(
        emb, k=4, metric="dot", exclude_self=False, query_batch=32, block=64, scores_out=True
    )
    full = emb @ emb.T
    for r in range(0, 100, 11):
        exp = np.sort(full[r])[::-1][:4]
        np.testing.assert_allclose(scores[r], exp, rtol=1e-5)


def _stage1_inputs(rng, n, b, d, metric, block):
    items = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    table, _ = R._pad_items(jnp.asarray(items, jnp.bfloat16), block)
    sq = np.sum(items**2, axis=1) if metric == "euclidean" else np.zeros(n)
    bias = jnp.asarray(np.concatenate(
        [sq, np.full(table.shape[0] - n, np.inf)]).astype(np.float32))
    scale = 2.0 if metric == "euclidean" else 1.0
    return items, q, table, bias, jnp.asarray(scale * q, jnp.bfloat16)


@pytest.mark.parametrize("b", [5, 70])  # neither a multiple of the query tile
@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_stage1_kernel_matches_reference(metric, b):
    """The Pallas stage 1 (interpret mode) keeps exactly the survivors of the
    plain-XLA reference: same values, same item indices, on a table whose
    rows are not a multiple of the block."""
    rng = np.random.default_rng(20 + b)
    block = 256
    _, _, table, bias, q1 = _stage1_inputs(rng, 2000, b, 32, metric, block)
    bp = -(-b // 16) * 16
    q1 = jnp.pad(q1, ((0, bp - b), (0, 0)))
    kv, ki = R._stage1(q1, table, bias, block=block, interpret=True)
    rv, ri = R.stage1_reference(q1, table, bias, block=block)
    kv, ki, rv, ri = map(np.asarray, (kv, ki, rv, ri))
    assert kv.shape == rv.shape == (bp, (table.shape[0] // block) * R.SURVIVORS)
    live = np.isfinite(rv)
    np.testing.assert_array_equal(np.isfinite(kv), live)
    np.testing.assert_allclose(kv[live], rv[live], rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(ki[live], ri[live])
    # survivors of a block are sorted descending, indices inside the block
    blocks = kv.reshape(bp, -1, R.SURVIVORS)
    assert (np.diff(np.where(np.isfinite(blocks), blocks, -1e30), axis=2) <= 0).all()
    blk_of = ki.reshape(bp, -1, R.SURVIVORS) // block
    owner = np.arange(blk_of.shape[1])[None, :, None]
    assert ((blk_of == owner) | ~np.isfinite(blocks)).all()


@pytest.mark.parametrize("k", [1, 20, 100])
@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_blocked_kernel_matches_plain_version(metric, k):
    """topk_blocked through the kernel (interpret mode) == the same three
    stages over the plain-XLA stage 1, for every k; rows (8500) are not a
    multiple of the block and queries (37) not a multiple of the tile."""
    rng = np.random.default_rng(k)
    items = rng.normal(size=(8500, 32)).astype(np.float32)
    q = rng.normal(size=(37, 32)).astype(np.float32)
    s, i = topk_blocked(q, items, k=k, metric=metric, block=256, interpret=True)
    s2, i2 = topk_blocked(q, items, k=k, metric=metric, block=256, reference=True)
    assert s.shape == i.shape == (37, k)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(s), np.asarray(s2), rtol=1e-6, atol=1e-5)
    # returned scores are the exact float32 scores of the returned items
    full = q.astype(np.float64) @ items.T.astype(np.float64)
    if metric == "euclidean":
        full = 2 * full - np.sum(items.astype(np.float64) ** 2, axis=1)[None, :]
    exp = np.take_along_axis(full, np.asarray(i), axis=1)
    np.testing.assert_allclose(np.asarray(s), exp, rtol=1e-5, atol=1e-4)
    assert (np.diff(np.asarray(s), axis=1) <= 0).all()


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_blocked_plain_version_matches_exact_scan(metric):
    """At a table size the router sends to the blocked path, the three
    stages (over the plain-XLA stage 1) recall >= 0.99 of topk_scan's exact
    float32 top-k, with exact scores."""
    k = 10
    n = 100 * R.SUB * R.n_candidates(k)
    assert R.blocked_fits(n, k) and not R.blocked_fits(n - 1, k)
    rng = np.random.default_rng(7)
    items = rng.normal(size=(n, 32)).astype(np.float32)
    q = rng.normal(size=(64, 32)).astype(np.float32)
    s, i = topk_blocked(q, items, k=k, metric=metric, reference=True)
    se, ie = topk_scan(q, items, k=k, metric=metric)
    i, ie = np.asarray(i), np.asarray(ie)
    recall = np.mean([len(set(a) & set(e)) / k for a, e in zip(i, ie)])
    assert recall >= 0.99
    same = i == ie
    np.testing.assert_allclose(np.asarray(s)[same], np.asarray(se)[same],
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("n,k,block", [
    (1_855_604, 100, 4096), (1_855_604, 21, 4096), (463_901, 100, 1024),
    (100_000, 21, 1024)])
def test_stage1_block_leaves_enough_blocks(n, k, block):
    assert R.stage1_block(n, k) == block
    assert n // block >= 2 * R.n_candidates(k)


@pytest.mark.parametrize("n,k,fits", [
    (1_855_604, 100, True), (1_855_604, 21, True), (400_000, 100, True),
    (399_999, 100, False), (60_000, 21, False), (3_000, 1, False)])
def test_route_by_table_rows(n, k, fits):
    assert R.blocked_fits(n, k) is fits


@pytest.mark.parametrize("n,expect", [(300, "scan"), (60_000, "blocked")])
def test_neighbor_table_routes_by_table_size(monkeypatch, n, expect):
    """build_neighbor_table takes the blocked path exactly when the table is
    large enough for it (k=5 fetches 6: 44,800 rows), else the exact scan."""
    calls = []

    def fake(name):
        def run(q, items, k, **kw):
            calls.append(name)
            return (jnp.zeros((q.shape[0], k), jnp.float32),
                    jnp.full((q.shape[0], k), -1, jnp.int32))
        return run

    monkeypatch.setattr(R, "topk_blocked", fake("blocked"))
    monkeypatch.setattr(R, "topk_scan", fake("scan"))
    emb = np.zeros((n, 16), np.float32)
    out = build_neighbor_table(emb, k=5, query_batch=min(n, 8192))
    assert out.shape == (n, 5)
    assert set(calls) == {expect}


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_neighbor_table_blocked_excludes_self(monkeypatch, metric):
    """exclude_self on the blocked path (kernel in interpret mode): the row
    never holds its own aid and is the blocked top-(k+1) minus self."""
    monkeypatch.setattr(R, "blocked_fits", lambda rows, k: True)
    rng = np.random.default_rng(9)
    emb = rng.normal(size=(3000, 16)).astype(np.float32)
    table = build_neighbor_table(emb, k=5, metric=metric, query_batch=256,
                                 interpret=True)
    assert table.shape == (3000, 5)
    assert not (table == np.arange(3000)[:, None]).any()
    _, raw = topk_blocked(emb[:256], emb, k=6, metric=metric, interpret=True)
    raw = np.asarray(raw)
    for r in range(0, 256, 17):
        np.testing.assert_array_equal(table[r], [a for a in raw[r] if a != r][:5])


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_stage1_kernel_compiled_on_gpu(gpu, metric):
    """The kernel as compiled for the card keeps the reference's survivors."""
    rng = np.random.default_rng(30)
    block = 1024
    _, _, table, bias, q1 = _stage1_inputs(rng, 50_000, 256, 32, metric, block)
    kv, ki = R._stage1(q1, table, bias, block=block, interpret=False)
    rv, ri = R.stage1_reference(q1, table, bias, block=block)
    kv, ki, rv, ri = map(np.asarray, (kv, ki, rv, ri))
    live = np.isfinite(rv)
    np.testing.assert_allclose(kv[live], rv[live], rtol=1e-5, atol=1e-4)
    assert (ki == ri)[live].mean() >= 0.999
