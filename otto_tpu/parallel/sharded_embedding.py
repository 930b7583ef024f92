"""Row-sharded embedding tables with collective lookup, sharded top-k
retrieval, and the multi-chip SGNS training step.

This is the model-parallel story for the only tensors at OTTO scale worth
sharding: the ~1.86M-row aid/session embedding tables (the reference holds
them whole on one GPU — torch_modules.py:28-29).  Rows are sharded across the
``model`` mesh axis; lookups mask to the local shard and ``psum`` the partial
gathers; retrieval takes a local top-k per shard then re-top-ks the
gathered candidates (the classic distributed top-k merge).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P



def sharded_lookup(mesh: Mesh, table, indices, model_axis: str = "model"):
    """Gather rows of a row-sharded table for replicated indices.

    table: [N_padded, D] sharded P(model_axis, None); indices: [B] replicated.
    Returns [B, D] replicated (psum of masked local gathers).
    """

    def local(table_shard, idx):
        m = jax.lax.axis_index(model_axis)
        rows_per = table_shard.shape[0]
        local_idx = idx - m * rows_per
        owned = (local_idx >= 0) & (local_idx < rows_per)
        safe = jnp.clip(local_idx, 0, rows_per - 1)
        rows = jnp.where(owned[:, None], table_shard[safe], 0)
        return jax.lax.psum(rows, model_axis)

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P(model_axis, None), P()),
        out_specs=P(),
    )(table, indices)


def sharded_topk(mesh: Mesh, queries, items, k: int, model_axis: str = "model",
                 metric: str = "dot", interpret: bool = False):
    """Distributed top-k: local top-k per item shard, all_gather the
    k-candidates, re-top-k.  queries [B, D] replicated; items [N_padded, D]
    row-sharded.  Returns (scores [B, k], global indices [B, k]).

    Shards large enough for :func:`otto_tpu.ops.retrieval.topk_blocked`
    (``blocked_fits``) take it as the local reduction; smaller ones score
    the [B, N_local] matrix densely and ``lax.top_k`` it.  ``interpret``
    runs the blocked path's kernel in interpret mode (tests only)."""
    from otto_tpu.ops.retrieval import blocked_fits, topk_blocked

    def local(q, item_shard):
        m = jax.lax.axis_index(model_axis)
        rows_per = item_shard.shape[0]
        if blocked_fits(rows_per, k):
            loc_s, loc_i = topk_blocked(q, item_shard, k=k, metric=metric,
                                        interpret=interpret)
            loc_i = jnp.maximum(loc_i, 0)  # dead slots carry NEG scores
        else:
            s = jnp.dot(q, item_shard.T, preferred_element_type=jnp.float32)
            if metric == "euclidean":
                s = 2.0 * s - jnp.sum(item_shard.astype(jnp.float32) ** 2, axis=1)[None, :]
            loc_s, loc_i = jax.lax.top_k(s, k)
        glob_i = loc_i + m * rows_per
        all_s = jax.lax.all_gather(loc_s, model_axis, axis=1)  # [B, n_shards, k]
        all_i = jax.lax.all_gather(glob_i, model_axis, axis=1)
        B = q.shape[0]
        all_s = all_s.reshape(B, -1)
        all_i = all_i.reshape(B, -1)
        best_s, pos = jax.lax.top_k(all_s, k)
        best_i = jnp.take_along_axis(all_i, pos, axis=1)
        return best_s, best_i

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(model_axis, None)),
        out_specs=(P(), P()),
        check_vma=False,  # all_gather+top_k replication is not statically inferred
    )(queries, items)


def make_sharded_sgns_step(mesh: Mesh, n_negatives: int, data_axis: str = "data",
                           model_axis: str = "model"):
    """Multi-chip SGNS step: batch sharded over ``data``, tables row-sharded
    over ``model``.  Each data shard computes gradients against the full
    (logically sharded) tables; gradient scatter-adds are psum'd over ``data``
    and applied to the local table shard."""

    def step(w_in, w_out, acc_in, acc_out, centers, contexts, negatives, lr):
        def local(w_in_s, w_out_s, acc_in_s, acc_out_s, c, x, negs, lr):
            m = jax.lax.axis_index(model_axis)
            rows_per = w_in_s.shape[0]

            def gather(table, idx):
                li = idx - m * rows_per
                owned = (li >= 0) & (li < rows_per)
                safe = jnp.clip(li, 0, rows_per - 1)
                rows = jnp.where(owned[..., None], table[safe], 0)
                return jax.lax.psum(rows, model_axis)

            def loss_fn(w_in_s, w_out_s):
                c_rows = gather(w_in_s, c)
                pos_rows = gather(w_out_s, x)
                neg_rows = gather(w_out_s, negs.reshape(-1)).reshape(*negs.shape, -1)
                pos_logit = jnp.sum(c_rows * pos_rows, axis=1)
                neg_logit = jnp.einsum("bd,bnd->bn", c_rows, neg_rows)
                per = -jax.nn.log_sigmoid(pos_logit) - jnp.sum(
                    jax.nn.log_sigmoid(-neg_logit), axis=1
                )
                return jnp.sum(per)

            loss, (g_in, g_out) = jax.value_and_grad(loss_fn, argnums=(0, 1))(w_in_s, w_out_s)
            # sum gradients over the data shards (each saw a different batch)
            g_in = jax.lax.psum(g_in, data_axis)
            g_out = jax.lax.psum(g_out, data_axis)
            loss = jax.lax.psum(loss, data_axis)
            acc_in_s = acc_in_s + g_in * g_in
            acc_out_s = acc_out_s + g_out * g_out
            w_in_s = w_in_s - lr * g_in * jax.lax.rsqrt(acc_in_s + 1e-10)
            w_out_s = w_out_s - lr * g_out * jax.lax.rsqrt(acc_out_s + 1e-10)
            return w_in_s, w_out_s, acc_in_s, acc_out_s, loss

        return shard_map(
            local,
            mesh=mesh,
            in_specs=(
                P(model_axis, None),
                P(model_axis, None),
                P(model_axis, None),
                P(model_axis, None),
                P(data_axis),
                P(data_axis),
                P(data_axis, None),
                P(),
            ),
            out_specs=(
                P(model_axis, None),
                P(model_axis, None),
                P(model_axis, None),
                P(model_axis, None),
                P(),
            ),
        )(w_in, w_out, acc_in, acc_out, centers, contexts, negatives, lr)

    return jax.jit(step, donate_argnums=(0, 1, 2, 3))


def make_sharded_mf_step(mesh: Mesh, loss: str = "mse", data_axis: str = "data",
                         model_axis: str = "model"):
    """Multi-chip matrix-factorization step: batch sharded over ``data``,
    BOTH tables (session [Ns, D] and aid [Na, D]) row-sharded over ``model``
    — the 14,571,582-row session table is the reference's largest tensor
    (models/matrix_factorization/config.yaml:8-9, torch_modules.py:28-29)
    and the real target of row sharding.

    Unlike :func:`make_sharded_sgns_step` (dense per-shard adagrad), the
    update is SPARSE: each data shard computes closed-form row gradients for
    its batch, the gradient rows are all-gathered over ``data`` (batch-sized
    traffic, not table-sized), and every model shard scatter-adds the rows it
    owns — per-step HBM traffic scales with the batch, as in the
    single-device sparse path (models/matrix_factorization.py sparse_step).
    """

    def step(ses_t, aid_t, acc_s, acc_a, s_idx, a_idx, y, lr):
        def local(ses_s, aid_s, acc_ss, acc_as, si, ai, yy, lr):
            m = jax.lax.axis_index(model_axis)
            rows_s = ses_s.shape[0]
            rows_a = aid_s.shape[0]

            def gather(table, idx, rows_per):
                li = idx - m * rows_per
                owned = (li >= 0) & (li < rows_per)
                safe = jnp.clip(li, 0, rows_per - 1)
                rows = jnp.where(owned[..., None], table[safe], 0)
                return jax.lax.psum(rows, model_axis)

            e1 = gather(ses_s, si, rows_s)  # [b, D]
            e2 = gather(aid_s, ai, rows_a)
            logits = jnp.sum(e1 * e2, axis=-1)
            B_total = yy.shape[0] * mesh.shape[data_axis]
            if loss == "bce":
                per = -(yy * jax.nn.log_sigmoid(logits)
                        + (1 - yy) * jax.nn.log_sigmoid(-logits))
                dl = (jax.nn.sigmoid(logits) - yy) / B_total
            else:  # mse
                per = (logits - yy) ** 2
                dl = 2.0 * (logits - yy) / B_total
            loss_val = jax.lax.psum(jnp.sum(per), data_axis) / B_total
            g1 = dl[:, None] * e2  # [b, D] session-row grads
            g2 = dl[:, None] * e1  # [b, D] aid-row grads

            # batch-sized exchange: every model shard sees ALL data shards'
            # gradient rows, then applies only the rows it owns
            si_all = jax.lax.all_gather(si, data_axis, tiled=True)
            ai_all = jax.lax.all_gather(ai, data_axis, tiled=True)
            g1_all = jax.lax.all_gather(g1, data_axis, tiled=True)
            g2_all = jax.lax.all_gather(g2, data_axis, tiled=True)

            def apply(table, acc, idx, g, rows_per):
                li = idx - m * rows_per
                owned = (li >= 0) & (li < rows_per)
                safe = jnp.where(owned, li, rows_per)  # row rows_per = scratch
                pad_t = jnp.concatenate([table, jnp.zeros((1, table.shape[1]), table.dtype)])
                pad_a = jnp.concatenate([acc, jnp.zeros((1, acc.shape[1]), acc.dtype)])
                g = jnp.where(owned[:, None], g, 0)
                pad_a = pad_a.at[safe].add(g * g)
                pad_t = pad_t.at[safe].add(
                    -lr * g * jax.lax.rsqrt(pad_a[safe] + 1e-10))
                return pad_t[:-1], pad_a[:-1]

            ses_s, acc_ss = apply(ses_s, acc_ss, si_all, g1_all, rows_s)
            aid_s, acc_as = apply(aid_s, acc_as, ai_all, g2_all, rows_a)
            return ses_s, aid_s, acc_ss, acc_as, loss_val

        return shard_map(
            local,
            mesh=mesh,
            in_specs=(
                P(model_axis, None), P(model_axis, None),
                P(model_axis, None), P(model_axis, None),
                P(data_axis), P(data_axis), P(data_axis), P(),
            ),
            out_specs=(
                P(model_axis, None), P(model_axis, None),
                P(model_axis, None), P(model_axis, None), P(),
            ),
            check_vma=False,
        )(ses_t, aid_t, acc_s, acc_a, s_idx, a_idx, y, lr)

    return jax.jit(step, donate_argnums=(0, 1, 2, 3))
