"""Multi-device sharding tests on the 8-virtual-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from otto_tpu.config import MeshConfig
from otto_tpu.parallel.data_parallel import make_dp_ranker_step
from otto_tpu.parallel.mesh import make_mesh, shard_rows
from otto_tpu.parallel.sharded_embedding import (
    make_sharded_sgns_step,
    sharded_lookup,
    sharded_topk,
)


@pytest.fixture(scope="module")
def mesh_2x4():
    assert len(jax.devices()) == 8
    return make_mesh(MeshConfig(data_parallel=2, model_parallel=4))


def test_mesh_shapes(mesh_2x4):
    assert mesh_2x4.shape == {"data": 2, "model": 4}


def test_sharded_lookup_matches_gather(mesh_2x4):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(103, 16)).astype(np.float32)
    sharded = shard_rows(mesh_2x4, table)  # pads to 104
    idx = rng.integers(0, 103, size=64).astype(np.int32)
    out = sharded_lookup(mesh_2x4, sharded, jnp.asarray(idx))
    np.testing.assert_allclose(np.asarray(out), table[idx], rtol=1e-6)


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_sharded_topk_matches_single_device(mesh_2x4, metric):
    rng = np.random.default_rng(1)
    items = rng.normal(size=(200, 16)).astype(np.float32)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    sharded = shard_rows(mesh_2x4, items)
    s, i = sharded_topk(mesh_2x4, jnp.asarray(q), sharded, k=7, metric=metric)
    s, i = np.asarray(s), np.asarray(i)
    # brute force over the padded table (pad rows, if any, are zero vectors
    # and are legitimate top-k entries when real scores are worse)
    n_pad = (-200) % mesh_2x4.shape["model"]
    padded = np.zeros((200 + n_pad, 16), np.float32)
    padded[:200] = items
    if metric == "dot":
        full = q @ padded.T
    else:
        full = 2 * q @ padded.T - np.sum(padded**2, axis=1)[None, :]
    exp_s = np.sort(full, axis=1)[:, ::-1][:, :7]
    np.testing.assert_allclose(s, exp_s, rtol=1e-4, atol=1e-5)


def test_sharded_sgns_step_runs_and_learns(mesh_2x4):
    rng = np.random.default_rng(2)
    N, D = 64, 8
    w_in = shard_rows(mesh_2x4, rng.uniform(-0.1, 0.1, (N, D)).astype(np.float32))
    w_out = shard_rows(mesh_2x4, np.zeros((N, D), np.float32))
    acc_in = shard_rows(mesh_2x4, np.zeros((N, D), np.float32))
    acc_out = shard_rows(mesh_2x4, np.zeros((N, D), np.float32))
    step = make_sharded_sgns_step(mesh_2x4, n_negatives=4)
    B = 32
    c = jnp.asarray(np.tile(np.array([1, 2], np.int32), B // 2))
    x = jnp.asarray(np.tile(np.array([3, 4], np.int32), B // 2))
    negs = jnp.asarray(rng.integers(10, 60, (B, 4)).astype(np.int32))
    losses = []
    for _ in range(30):
        w_in, w_out, acc_in, acc_out, loss = step(
            w_in, w_out, acc_in, acc_out, c, x, negs, jnp.float32(0.1)
        )
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    w_in_np = np.asarray(w_in)
    w_out_np = np.asarray(w_out)
    assert w_in_np[1] @ w_out_np[3] > 0.1  # positive pair aligned


def test_dp_ranker_step_matches_single_device():
    mesh = make_mesh(MeshConfig(data_parallel=8, model_parallel=1))
    rng = np.random.default_rng(3)
    B, C, F = 16, 8, 4
    x = rng.normal(size=(B, C, F)).astype(np.float32)
    y = (rng.random((B, C)) < 0.3).astype(np.int8)
    m = np.ones((B, C), bool)

    from otto_tpu.models.ranker import init_tower, LOSSES, tower_forward

    params = init_tower(jax.random.PRNGKey(0), F, (8,))
    optimizer = optax.sgd(0.1)
    opt_state = optimizer.init(params)
    # single-device reference step first (the dp step donates its params)
    def f(p):
        return LOSSES["bce"](tower_forward(p, jnp.asarray(x)), jnp.asarray(y), jnp.asarray(m))

    loss_ref, grads = jax.value_and_grad(f)(params)
    updates, _ = optimizer.update(grads, optimizer.init(params), params)
    p_ref = optax.apply_updates(params, updates)

    step = make_dp_ranker_step(mesh, optimizer, loss_name="bce", dropout=0.0)
    p2, _, loss_dp = step(params, opt_state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                          jax.random.PRNGKey(1))
    # dp loss = mean over shards of per-shard means; equals global mean when
    # shards are equal-sized
    assert float(loss_dp) == pytest.approx(float(loss_ref), rel=1e-5)
    for k in params:
        np.testing.assert_allclose(np.asarray(p2[k]), np.asarray(p_ref[k]), rtol=2e-4, atol=1e-6)


def test_host_shard_sessions_partition():
    from otto_tpu.parallel.mesh import host_shard_sessions

    parts = [host_shard_sessions(103, pi, 4) for pi in range(4)]
    allidx = np.concatenate(parts)
    np.testing.assert_array_equal(np.sort(allidx), np.arange(103))
    assert max(len(p) for p in parts) - min(len(p) for p in parts) <= 26


def test_dp_sequence_step_matches_single_device():
    """DP sequence training over the 8-device mesh computes the same loss and
    params as a single-device step on the full batch (both architectures)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from otto_tpu.config import MeshConfig
    from otto_tpu.models.sequence import encode, init_params
    from otto_tpu.parallel.data_parallel import make_dp_sequence_step
    from otto_tpu.parallel.mesh import make_mesh

    for arch in ("gru", "transformer"):
        mesh = make_mesh(MeshConfig(data_parallel=8, model_parallel=1))
        params = init_params(jax.random.PRNGKey(0), 40, 16, 8, architecture=arch,
                             max_len=6, n_layers=1, n_heads=2)
        optimizer = optax.adam(1e-2)
        opt_state = optimizer.init(params)
        rng = np.random.default_rng(0)
        B, L, NEG = 16, 6, 4
        seq = jnp.asarray(rng.integers(0, 40, (B, L)).astype(np.int32))
        mask = jnp.asarray(np.ones((B, L), bool))
        tgt = jnp.asarray(rng.integers(0, 40, B).astype(np.int32))
        negs = jnp.asarray(rng.integers(0, 40, (B, NEG)).astype(np.int32))

        step = make_dp_sequence_step(mesh, optimizer)
        p2, _, loss = step(jax.tree.map(jnp.copy, params), opt_state, seq, mask, tgt, negs)

        # single-device oracle
        def f(p):
            h = encode(p, seq, mask)
            pos = jnp.sum(h * p["item_emb"][tgt], axis=1)
            neg = jnp.einsum("bd,bnd->bn", h, p["item_emb"][negs])
            logits = jnp.concatenate([pos[:, None], neg], axis=1)
            return -jnp.mean(jax.nn.log_softmax(logits, axis=1)[:, 0])

        ref_loss, grads = jax.value_and_grad(f)(params)
        updates, _ = optimizer.update(grads, optimizer.init(params), params)
        ref_params = optax.apply_updates(params, updates)

        assert abs(float(loss) - float(ref_loss)) < 1e-4, arch
        for a, b in zip(jax.tree.leaves(p2), jax.tree.leaves(ref_params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)


def test_zero_sequence_step_matches_dp():
    """ZeRO-1 (optimizer state sharded over the data axis) is the same math
    as plain replicated-state DP: identical losses and params over several
    Adam steps, while the stored state is 1/dp per device."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from otto_tpu.config import MeshConfig
    from otto_tpu.models.sequence import init_params
    from otto_tpu.parallel.data_parallel import (
        make_dp_sequence_step, make_zero_sequence_step, zero_init)
    from otto_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(data_parallel=8, model_parallel=1))
    params = init_params(jax.random.PRNGKey(0), 40, 16, 8,
                         architecture="transformer", max_len=6,
                         n_layers=2, n_heads=2)
    optimizer = optax.adamw(1e-2)
    rng = np.random.default_rng(1)
    B, L, NEG = 16, 6, 4

    def batch(i):
        r = np.random.default_rng(i)
        return (jnp.asarray(r.integers(0, 40, (B, L)).astype(np.int32)),
                jnp.asarray(np.ones((B, L), bool)),
                jnp.asarray(r.integers(0, 40, B).astype(np.int32)),
                jnp.asarray(r.integers(0, 40, (B, NEG)).astype(np.int32)))

    dstep = make_dp_sequence_step(mesh, optimizer)
    zstep = make_zero_sequence_step(mesh, optimizer)
    pd = jax.tree.map(jnp.copy, params)
    pz = jax.tree.map(jnp.copy, params)
    sd = optimizer.init(pd)
    sz = zero_init(mesh, optimizer, pz)

    # sharded state is 1/dp of the replicated state (plus per-shard scalars)
    n_rep = sum(x.size for x in jax.tree.leaves(sd))
    n_sh = sum(int(np.prod(x.shape[1:])) for x in jax.tree.leaves(sz))
    assert n_sh <= n_rep / 8 + len(jax.tree.leaves(sz))

    for i in range(3):
        b = batch(i)
        pd, sd, ld = dstep(pd, sd, *b)
        pz, sz, lz = zstep(pz, sz, *b)
        assert abs(float(ld) - float(lz)) < 1e-5, i
    for a, b in zip(jax.tree.leaves(pd), jax.tree.leaves(pz)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_ranker_mesh_predict_matches_single_device():
    """mesh= predict shards batches over the data axis and matches the
    single-device fold-averaged scores."""
    import jax
    import numpy as np

    from otto_tpu.config import MeshConfig, RankerConfig
    from otto_tpu.models.ranker import FeatureNormalizer, RankerModel, init_tower
    from otto_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    S, C, F = 37, 16, 12  # deliberately not divisible by 8
    feats = rng.normal(size=(S, C, F)).astype(np.float32)
    mask = rng.random((S, C)) < 0.9
    norm = FeatureNormalizer.fit(feats, mask)
    params = [init_tower(jax.random.PRNGKey(i), F, (32, 16)) for i in range(3)]
    model = RankerModel(params, norm, RankerConfig())

    single = model.predict(feats, mask, batch=16)
    mesh = make_mesh(MeshConfig(data_parallel=8, model_parallel=1))
    parallel = model.predict(feats, mask, batch=16, mesh=mesh)
    np.testing.assert_allclose(single, parallel, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_sharded_topk_blocked_local_path(monkeypatch, metric):
    """Shards routed to the blocked path (kernel in interpret mode) merge to
    the same top-k as each shard's own blocked top-k, with exact scores."""
    import otto_tpu.ops.retrieval as R
    from otto_tpu.parallel import sharded_embedding as se

    monkeypatch.setattr(R, "blocked_fits", lambda rows, k: True)
    rng = np.random.default_rng(4)
    n_dev = len(jax.devices())
    mesh = make_mesh(MeshConfig(data_parallel=1, model_parallel=n_dev))
    rows, D, k = 1024, 16, 5
    items = rng.normal(size=(rows * n_dev, D)).astype(np.float32)
    q = rng.normal(size=(8, D)).astype(np.float32)
    s, i = se.sharded_topk(mesh, jnp.asarray(q), shard_rows(mesh, items), k=k,
                           metric=metric, interpret=True)
    s, i = np.asarray(s), np.asarray(i)
    # reference: each shard's blocked top-k, merged on the host
    cand_s, cand_i = [], []
    for m in range(n_dev):
        ls, li = R.topk_blocked(q, items[m * rows:(m + 1) * rows], k=k,
                                metric=metric, reference=True)
        cand_s.append(np.asarray(ls))
        cand_i.append(np.asarray(li) + m * rows)
    cand_s, cand_i = np.concatenate(cand_s, 1), np.concatenate(cand_i, 1)
    order = np.argsort(-cand_s, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(i, np.take_along_axis(cand_i, order, 1))
    full = q @ items.T
    if metric == "euclidean":
        full = 2 * full - np.sum(items**2, axis=1)[None, :]
    np.testing.assert_allclose(s, np.take_along_axis(full, i, axis=1),
                               rtol=1e-5, atol=1e-4)


def test_sharded_mf_step_matches_numpy_oracle(mesh_2x4):
    """make_sharded_mf_step == the single-device sparse-adagrad closed form
    (models/matrix_factorization.py sparse_step semantics): batch-complete
    squared-grad accumulation, then the update at the final accumulator."""
    from otto_tpu.parallel.sharded_embedding import make_sharded_mf_step

    rng = np.random.default_rng(4)
    Ns, Na, D, B = 10, 9, 4, 16
    ses = rng.normal(size=(Ns, D)).astype(np.float32) * 0.1
    aid = rng.normal(size=(Na, D)).astype(np.float32) * 0.1
    si = rng.integers(0, Ns, B).astype(np.int32)
    ai = rng.integers(0, Na, B).astype(np.int32)
    y = rng.normal(size=B).astype(np.float32)
    lr = 0.07

    # numpy oracle (mse)
    e1, e2 = ses[si], aid[ai]
    logits = np.sum(e1 * e2, axis=-1)
    dl = 2.0 * (logits - y) / B
    g1 = dl[:, None] * e2
    g2 = dl[:, None] * e1
    acc_s = np.zeros_like(ses)
    acc_a = np.zeros_like(aid)
    np.add.at(acc_s, si, g1 * g1)
    np.add.at(acc_a, ai, g2 * g2)
    exp_s, exp_a = ses.copy(), aid.copy()
    np.add.at(exp_s, si, -lr * g1 / np.sqrt(acc_s[si] + 1e-10))
    np.add.at(exp_a, ai, -lr * g2 / np.sqrt(acc_a[ai] + 1e-10))
    exp_loss = np.mean((logits - y) ** 2)

    step = make_sharded_mf_step(mesh_2x4, loss="mse")
    ses_d = shard_rows(mesh_2x4, ses)
    aid_d = shard_rows(mesh_2x4, aid)
    zs = shard_rows(mesh_2x4, np.zeros_like(ses))
    za = shard_rows(mesh_2x4, np.zeros_like(aid))
    out = step(ses_d, aid_d, zs, za, jnp.asarray(si), jnp.asarray(ai),
               jnp.asarray(y), jnp.float32(lr))
    got_s = np.asarray(out[0])[:Ns]
    got_a = np.asarray(out[1])[:Na]
    np.testing.assert_allclose(float(out[4]), exp_loss, rtol=1e-5)
    np.testing.assert_allclose(got_s, exp_s, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got_a, exp_a, rtol=2e-5, atol=2e-6)
