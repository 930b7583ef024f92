"""Data-parallel training for the ranking tower.

Parameters are replicated; the session batch is sharded over the ``data``
mesh axis; gradients are ``psum``-averaged over the interconnect.  This is the
data-parallelism the reference lacks entirely (SURVEY §2.10: no DDP)."""

from __future__ import annotations

import jax
import optax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from otto_tpu.models.ranker import LOSSES, tower_forward


def make_dp_ranker_step(mesh: Mesh, optimizer, loss_name: str = "lambdarank",
                        dropout: float = 0.0, data_axis: str = "data"):
    """Returns a jitted step(params, opt_state, x [B,C,F], y, m, key)."""
    loss_fn = LOSSES[loss_name]

    def step(params, opt_state, x, y, m, key):
        def local(params, opt_state, x, y, m, key):
            key = jax.random.fold_in(key, jax.lax.axis_index(data_axis))

            def f(p):
                scores = tower_forward(p, x, dropout_rate=dropout, key=key)
                return loss_fn(scores, y, m)

            loss, grads = jax.value_and_grad(f)(params)
            grads = jax.lax.pmean(grads, data_axis)
            loss = jax.lax.pmean(loss, data_axis)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        return shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(), P(data_axis), P(data_axis), P(data_axis), P()),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )(params, opt_state, x, y, m, key)

    return jax.jit(step, donate_argnums=(0, 1))


def make_dp_sequence_step(mesh: Mesh, optimizer, data_axis: str = "data"):
    """Data-parallel training step for the sequential recommender (GRU or
    transformer — dispatch follows the param pytree): the (seq, mask, target,
    negatives) batch shards over the ``data`` axis, parameters replicate,
    gradients pmean over the interconnect.  Same sampled-softmax objective as
    models.sequence.train_sequence_model."""
    import jax.numpy as jnp

    from otto_tpu.models.sequence import encode

    def step(params, opt_state, seq, mask, tgt, negs):
        def local(params, opt_state, seq, mask, tgt, negs):
            def f(p):
                h = encode(p, seq, mask)
                pos_e = p["item_emb"][tgt]
                neg_e = p["item_emb"][negs]
                pos_logit = jnp.sum(h * pos_e, axis=1)
                neg_logit = jnp.einsum("bd,bnd->bn", h, neg_e)
                logits = jnp.concatenate([pos_logit[:, None], neg_logit], axis=1)
                return -jnp.mean(jax.nn.log_softmax(logits, axis=1)[:, 0])

            loss, grads = jax.value_and_grad(f)(params)
            grads = jax.lax.pmean(grads, data_axis)
            loss = jax.lax.pmean(loss, data_axis)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        return shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(), P(data_axis), P(data_axis), P(data_axis), P(data_axis)),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )(params, opt_state, seq, mask, tgt, negs)

    return jax.jit(step, donate_argnums=(0, 1))


def make_dp_gbdt_grow(mesh: Mesh, *, depth: int, n_bins: int,
                      hist_chunk: int = 1 << 18, data_axis: str = "data",
                      hist_impl: str = "matmul"):
    """Data-parallel GBDT tree growth: rows shard over ``data``; each device
    builds local histograms and one ``psum`` per level merges them over the
    interconnect (bytes per level = nodes * features * bins * 3 * 4, independent of row
    count); split search runs redundantly so every device grows the identical
    tree; rows route locally.  The reference's LightGBM/XGBoost engines are
    single-node OpenMP — this is the scale-out they lack.

    Returns ``grow(binned, grad, hess, weight, bag, feat_mask, reg_lambda,
    min_split_gain, min_data_in_leaf, min_child_weight, learning_rate)`` with
    the row-dimension inputs sharded over ``data`` and the tree outputs
    replicated (leaf ids stay sharded)."""
    from functools import partial

    from otto_tpu.models.gbdt import _grow_tree_impl

    fn = partial(_grow_tree_impl, depth=depth, n_bins=n_bins,
                 hist_chunk=hist_chunk, axis_name=data_axis,
                 hist_impl=hist_impl)
    D, R = P(data_axis), P()
    return jax.jit(shard_map(
        fn,
        mesh=mesh,
        in_specs=(D, D, D, D, D, R, R, R, R, R, R),
        out_specs=(R, R, R, R, D),
        check_vma=False,
    ))


# --------------------------------------------------------------------------
# ZeRO-1: optimizer-state sharding over the data axis
# --------------------------------------------------------------------------
#
# Plain data parallelism replicates the optimizer state (for Adam, 2x the
# model bytes) on every device.  ZeRO stage 1 shards it: gradients
# reduce-scatter over ``data`` so each device averages only its 1/dp slice,
# the optimizer updates that slice against its parameter shard, and an
# all_gather rebuilds the full parameter tree for the next forward.  Wire
# bytes per step match plain dp (reduce_scatter + all_gather == all_reduce);
# optimizer memory drops by dp.  Exact for elementwise optax transforms
# (sgd/adam/adamw/adagrad/...): sharding a leaf's flat vector commutes with
# any per-element update rule.

def _shard_leaf(leaf, dp: int, idx):
    """This device's 1/dp slice of a leaf's flattened (padded) vector."""
    import jax.numpy as jnp

    flat = leaf.reshape(-1)
    per = -(-flat.shape[0] // dp)
    flat = jnp.pad(flat, (0, per * dp - flat.shape[0]))
    return jax.lax.dynamic_slice(flat, (idx * per,), (per,))


def _scatter_mean_grad(g, dp: int, data_axis: str):
    """reduce_scatter a gradient leaf: each device keeps the mean of its
    1/dp slice (one collective, same bytes as its half of an all_reduce)."""
    import jax.numpy as jnp

    flat = g.reshape(-1)
    per = -(-flat.shape[0] // dp)
    flat = jnp.pad(flat, (0, per * dp - flat.shape[0]))
    return jax.lax.psum_scatter(flat.reshape(dp, per), data_axis,
                                scatter_dimension=0) / dp


def _unshard_leaf(shard, like, data_axis: str):
    import jax.numpy as jnp

    full = jax.lax.all_gather(shard, data_axis, tiled=True)
    return full[: like.size].reshape(like.shape)


def zero_init(mesh: Mesh, optimizer, params, data_axis: str = "data"):
    """Initialize ZeRO-sharded optimizer state: every leaf carries a leading
    per-device axis sharded over ``data`` (scalars like Adam's ``count`` are
    duplicated per shard).  Pass the result to a ``make_zero_*`` step."""
    dp = mesh.shape[data_axis]

    def local(params):
        idx = jax.lax.axis_index(data_axis)
        psh = jax.tree.map(lambda p: _shard_leaf(p, dp, idx), params)
        st = optimizer.init(psh)
        return jax.tree.map(lambda a: a[None], st)

    return jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(),), out_specs=P(data_axis),
        check_vma=False,
    ))(params)


def make_zero_step(mesh: Mesh, optimizer, loss_fn, n_batch_args: int,
                   data_axis: str = "data"):
    """ZeRO-1 data-parallel step for any ``loss_fn(params, *batch) -> scalar``
    with ``n_batch_args`` batch arrays sharded over ``data``.  Params stay
    replicated in HBM between steps; optimizer state lives sharded (from
    :func:`zero_init`).  Returns ``step(params, opt_state, *batch)``."""
    dp = mesh.shape[data_axis]

    def step(params, opt_state, *batch):
        def local(params, opt_state, *batch):
            idx = jax.lax.axis_index(data_axis)
            loss, grads = jax.value_and_grad(loss_fn)(params, *batch)
            loss = jax.lax.pmean(loss, data_axis)
            gsh = jax.tree.map(lambda g: _scatter_mean_grad(g, dp, data_axis), grads)
            psh = jax.tree.map(lambda p: _shard_leaf(p, dp, idx), params)
            st = jax.tree.map(lambda a: a[0], opt_state)
            updates, st = optimizer.update(gsh, st, psh)
            psh = optax.apply_updates(psh, updates)
            params = jax.tree.map(
                lambda s, p: _unshard_leaf(s, p, data_axis), psh, params)
            return params, jax.tree.map(lambda a: a[None], st), loss

        D = P(data_axis)
        return shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), D) + (D,) * n_batch_args,
            out_specs=(P(), D, P()),
            check_vma=False,
        )(params, opt_state, *batch)

    return jax.jit(step, donate_argnums=(0, 1))


def make_zero_sequence_step(mesh: Mesh, optimizer, data_axis: str = "data"):
    """ZeRO-1 twin of :func:`make_dp_sequence_step` (same math, optimizer
    state sharded dp-ways): ``step(params, opt_state, seq, mask, tgt, negs)``
    with ``opt_state`` from :func:`zero_init`."""
    import jax.numpy as jnp

    from otto_tpu.models.sequence import encode

    def loss_fn(p, seq, mask, tgt, negs):
        h = encode(p, seq, mask)
        pos_e = p["item_emb"][tgt]
        neg_e = p["item_emb"][negs]
        pos_logit = jnp.sum(h * pos_e, axis=1)
        neg_logit = jnp.einsum("bd,bnd->bn", h, neg_e)
        logits = jnp.concatenate([pos_logit[:, None], neg_logit], axis=1)
        return -jnp.mean(jax.nn.log_softmax(logits, axis=1)[:, 0])

    return make_zero_step(mesh, optimizer, loss_fn, 4, data_axis)
