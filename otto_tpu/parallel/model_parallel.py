"""Tensor-, sequence-, and pipeline-parallel training for the session
transformer (the sequential-recommender family, models/sequence.py).

The reference has no model parallelism of any kind (SURVEY §2.10: single
GPU, no NCCL/MPI).  These are the mesh-native sharding strategies the
framework adds on top of data parallelism (parallel/data_parallel.py) and
row-sharded embedding tables (parallel/sharded_embedding.py):

- **Tensor parallelism** (:func:`make_tp_sequence_step`) — Megatron-style:
  attention heads and the FFN hidden dimension shard over the ``model``
  axis; one ``psum`` after the attention output projection and one after
  the FFN down-projection per layer ride the interconnect.
- **Sequence parallelism** (``sequence_parallel=True``) — the LN/residual
  regions between the sharded matmuls keep activations sharded along the
  sequence axis; each layer's two ``psum``\\ s become
  ``all_gather``/``psum_scatter`` pairs (same bytes on the wire, 1/mp the
  activation memory), exactly the Megatron-LM sequence-parallel recipe.
  Session sequences are short (SURVEY §5.7), so this is a memory knob, not
  a latency one — ring attention is deliberately absent.
- **Pipeline parallelism** (:func:`make_pp_sequence_step`) — GPipe-style:
  transformer layers split into one stage per ``model``-axis device;
  microbatches stream through the stages with ``ppermute`` hops; the
  bubble is ``(S-1)/(n_micro+S-1)``.

All three build the loss as a ``shard_map`` program and differentiate
*through* it with an outer ``jax.value_and_grad``: the shard_map transpose
turns forward ``psum``/``all_gather``/``ppermute`` into their adjoint
collectives and sums replicated-parameter cotangents across shards, which
sidesteps the usual hand-placed all-reduce bookkeeping for mixed
replicated/sharded parameter trees.  The loss is computed redundantly on
every model shard but *counted* on shard 0 only (``_on_shard0``) so those
cotangent sums are exact.

Data parallelism composes with all of these: batches shard over ``data``,
parameter gradients sum over it through the same transpose.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from otto_tpu.models.sequence import _layer_norm, transformer_block


def _sampled_softmax(h, item_emb, tgt, negs):
    """One positive vs sampled negatives (same objective as
    models.sequence.train_sequence_model)."""
    pos_e = item_emb[tgt]
    neg_e = item_emb[negs]
    pos_logit = jnp.sum(h * pos_e, axis=1)
    neg_logit = jnp.einsum("bd,bnd->bn", h, neg_e)
    logits = jnp.concatenate([pos_logit[:, None], neg_logit], axis=1)
    return -jnp.mean(jax.nn.log_softmax(logits, axis=1)[:, 0])


def _on_shard0(loss, model_axis):
    """Zero the loss on all but model-shard 0, so that summing the per-shard
    outputs (and, through the transpose, summing replicated-parameter
    cotangents across shards) counts each contribution exactly once."""
    on0 = jax.lax.axis_index(model_axis) == 0
    return loss * on0.astype(loss.dtype)


# --------------------------------------------------------------------------
# tensor parallelism (+ optional sequence parallelism)
# --------------------------------------------------------------------------

def _ln_spec():
    return {"scale": P(), "bias": P()}


def _tp_layer_spec(layer, model_axis: str):
    """Megatron-style PartitionSpecs for one transformer layer's params:
    wq/wk/wv shard on the head axis, wo on its (head-major) input rows,
    ffn_w1/b1 on the hidden columns, ffn_w2 on the hidden rows (or, for MoE
    layers, experts shard over the axis — expert parallelism)."""
    spec = {
        "wq": P(None, model_axis, None),
        "wk": P(None, model_axis, None),
        "wv": P(None, model_axis, None),
        "wo": P(model_axis, None),
        "ln1": _ln_spec(),
        "ln2": _ln_spec(),
    }
    if "moe" in layer:
        from otto_tpu.ops.moe import moe_param_specs

        spec["moe"] = moe_param_specs(model_axis)
    else:
        spec.update(
            ffn_w1=P(None, model_axis),
            ffn_b1=P(model_axis),
            ffn_w2=P(model_axis, None),
            ffn_b2=P(),
        )
    return spec


def tp_param_specs(params, model_axis: str = "model"):
    """PartitionSpec pytree for ``models.sequence.init_params`` transformer
    params under Megatron-style tensor parallelism (see
    :func:`_tp_layer_spec`); embeddings / head / norms replicate."""
    return {
        "item_emb": P(),
        "pos_emb": P(),
        "out_proj": P(),
        "final_ln": _ln_spec(),
        "layers": [_tp_layer_spec(l, model_axis) for l in params["layers"]],
    }


def shard_params(mesh: Mesh, params, specs):
    """Place a param pytree on the mesh per a matching PartitionSpec tree."""
    return jax.tree.map(
        lambda a, s: jax.device_put(jnp.asarray(a), NamedSharding(mesh, s)),
        params, specs,
    )


def _tp_block(layer, x, attn_ok, model_axis: str, sp: bool):
    """Transformer block with local attention heads / FFN hidden shard.

    Without sequence parallelism ``x`` is the full [B, L, D] activation and
    each sharded matmul ends in a ``psum``; with it ``x`` is the [B, L/mp, D]
    local sequence slice and the pair becomes all_gather + psum_scatter."""
    hd = layer["wq"].shape[-1]
    h = _layer_norm(layer["ln1"], x)
    if sp:
        h = jax.lax.all_gather(h, model_axis, axis=1, tiled=True)
    B, L, D = h.shape
    q = jnp.einsum("bld,dhk->blhk", h, layer["wq"])  # local heads only
    k = jnp.einsum("bld,dhk->blhk", h, layer["wk"])
    v = jnp.einsum("bld,dhk->blhk", h, layer["wv"])
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    logits = jnp.where(attn_ok[:, None], logits, -1e9)
    att = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, -1)
    part = out @ layer["wo"]  # wo rows are head-major: local slice lines up
    if sp:
        red = jax.lax.psum_scatter(part, model_axis, scatter_dimension=1, tiled=True)
    else:
        red = jax.lax.psum(part, model_axis)
    x = x + red
    l_loc = x.shape[1]
    h = _layer_norm(layer["ln2"], x)
    if sp:
        h = jax.lax.all_gather(h, model_axis, axis=1, tiled=True)
    if "moe" in layer:
        # expert-parallel FFN: experts shard over the axis, moe_apply's psum
        # combines them (already replicated — under sp just take our slice)
        from otto_tpu.models.sequence import _moe_ffn

        red = _moe_ffn(layer["moe"], h, attn_ok, model_axis=model_axis)
        if sp:
            m = jax.lax.axis_index(model_axis)
            red = jax.lax.dynamic_slice_in_dim(red, m * l_loc, l_loc, axis=1)
        return x + red
    part = jax.nn.gelu(h @ layer["ffn_w1"] + layer["ffn_b1"]) @ layer["ffn_w2"]
    if sp:
        red = jax.lax.psum_scatter(part, model_axis, scatter_dimension=1, tiled=True)
    else:
        red = jax.lax.psum(part, model_axis)
    return x + red + layer["ffn_b2"]


def tp_encode(params, seq, mask, *, mp: int, model_axis: str = "model",
              sequence_parallel: bool = False, remat: bool = False):
    """Sharded-parameter twin of ``models.sequence.encode`` (transformer
    branch); must run inside ``shard_map`` with :func:`tp_param_specs`
    layouts.  Returns replicated [B, dim] session vectors.

    ``remat=True`` wraps each block in ``jax.checkpoint`` so backward
    recomputes block activations instead of storing them — activation memory
    drops from O(n_layers) blocks to O(1) at ~1/3 more block FLOPs, the
    standard trade once B*L*D outgrows VMEM/HBM headroom.  Collectives
    inside the block (psum / all_gather / psum_scatter) replay in the
    recompute, which XLA schedules on the interconnect like any forward collective."""
    B, L = seq.shape
    x = params["item_emb"][seq] + params["pos_emb"][None, :L]
    x = jnp.where(mask[:, :, None], x, 0.0)
    causal = jnp.tril(jnp.ones((L, L), bool))
    attn_ok = causal[None] & mask[:, None, :]
    sp = sequence_parallel and mp > 1
    if sp:
        if L % mp:
            raise ValueError(f"sequence_parallel needs L ({L}) % mp ({mp}) == 0")
        m = jax.lax.axis_index(model_axis)
        x = jax.lax.dynamic_slice_in_dim(x, m * (L // mp), L // mp, axis=1)
    block = _tp_block
    if remat:
        block = jax.checkpoint(_tp_block, static_argnums=(3, 4))
    for layer in params["layers"]:
        x = block(layer, x, attn_ok, model_axis, sp)
    if sp:
        x = jax.lax.all_gather(x, model_axis, axis=1, tiled=True)
    x = _layer_norm(params["final_ln"], x)
    last = jnp.maximum(jnp.sum(mask, axis=1) - 1, 0)
    h_last = jnp.take_along_axis(x, last[:, None, None], axis=1)[:, 0]
    return h_last @ params["out_proj"]


def make_tp_sequence_step(mesh: Mesh, optimizer, *, sequence_parallel: bool = False,
                          remat: bool = False,
                          data_axis: str = "data", model_axis: str = "model"):
    """Tensor(+sequence)-parallel training step for the transformer
    sequential recommender.  Params live sharded per :func:`tp_param_specs`
    (use :func:`shard_params`); the batch shards over ``data``.

    Returns ``step(params, opt_state, seq, mask, tgt, negs) -> (params,
    opt_state, loss)``."""
    mp = mesh.shape[model_axis]
    dp = mesh.shape[data_axis]

    def step(params, opt_state, seq, mask, tgt, negs):
        specs = tp_param_specs(params, model_axis)

        def local(p, seq, mask, tgt, negs):
            h = tp_encode(p, seq, mask, mp=mp, model_axis=model_axis,
                          sequence_parallel=sequence_parallel, remat=remat)
            loss = _sampled_softmax(h, p["item_emb"], tgt, negs)
            return _on_shard0(loss, model_axis).reshape(1, 1)

        def loss_fn(p):
            out = shard_map(
                local,
                mesh=mesh,
                in_specs=(specs, P(data_axis), P(data_axis), P(data_axis), P(data_axis)),
                out_specs=P(data_axis, model_axis),
                check_vma=False,
            )(p, seq, mask, tgt, negs)
            return jnp.sum(out) / dp

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return jax.jit(step, donate_argnums=(0, 1))


# --------------------------------------------------------------------------
# pipeline parallelism
# --------------------------------------------------------------------------

def stack_pipeline_params(params, n_stages: int):
    """Re-lay transformer params for the pipeline: the per-layer list becomes
    a ``stage_layers`` pytree with leaves [n_stages, layers_per_stage, ...]
    (leading axis sharded over ``model``); shared leaves stay as-is."""
    layers = params["layers"]
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers not divisible into {n_stages} stages")
    per = len(layers) // n_stages
    stacked = jax.tree.map(
        lambda *xs: jnp.stack(xs).reshape(n_stages, per, *np.shape(xs[0])), *layers
    )
    out = {k: v for k, v in params.items() if k != "layers"}
    out["stage_layers"] = stacked
    return out


def pp_param_specs(params, model_axis: str = "model"):
    """Spec tree for :func:`stack_pipeline_params` output: stages shard over
    ``model``; embeddings / head replicate."""
    return {
        "item_emb": P(),
        "pos_emb": P(),
        "out_proj": P(),
        "final_ln": {"scale": P(), "bias": P()},
        "stage_layers": jax.tree.map(lambda _: P(model_axis), params["stage_layers"]),
    }


def make_pp_sequence_step(mesh: Mesh, optimizer, *, n_micro: int, remat: bool = False,
                          data_axis: str = "data", model_axis: str = "model"):
    """GPipe pipeline-parallel training step: the ``model`` axis is the
    pipeline, each device owns ``n_layers/S`` transformer layers; the local
    batch splits into ``n_micro`` microbatches streamed through the stages
    with one ``ppermute`` hop per tick (``n_micro + S - 1`` ticks total).
    Backward reuses the same schedule through the transpose.

    At demo scale every stage evaluates the embedding and loss head each
    tick and masks unused results — the schedule stays static for XLA; on a
    real pod gate those with ``lax.cond`` if the head dominates.

    Params use :func:`stack_pipeline_params` + :func:`pp_param_specs`."""
    S = mesh.shape[model_axis]
    dp = mesh.shape[data_axis]

    def step(params, opt_state, seq, mask, tgt, negs):
        specs = pp_param_specs(params, model_axis)
        lead = np.shape(jax.tree.leaves(params["stage_layers"])[0])
        if lead[0] != S:
            raise ValueError(
                f"stage_layers has {lead[0]} stages but the mesh's "
                f"{model_axis!r} axis has {S} devices — call "
                f"stack_pipeline_params(params, {S})"
            )
        per = int(lead[1])

        def local(p, seq, mask, tgt, negs):
            stage = jax.lax.axis_index(model_axis)
            sl = jax.tree.map(lambda a: a[0], p["stage_layers"])  # my stage
            b_loc, L = seq.shape
            if b_loc % n_micro:
                raise ValueError(f"local batch {b_loc} not divisible by n_micro={n_micro}")
            mbs = b_loc // n_micro
            seqs = seq.reshape(n_micro, mbs, L)
            masks = mask.reshape(n_micro, mbs, L)
            tgts = tgt.reshape(n_micro, mbs)
            negss = negs.reshape(n_micro, mbs, -1)
            D = p["pos_emb"].shape[1]
            causal = jnp.tril(jnp.ones((L, L), bool))

            def embed(s, m):
                x = p["item_emb"][s] + p["pos_emb"][None, :L]
                return jnp.where(m[:, :, None], x, 0.0)

            buf = jnp.zeros((mbs, L, D), p["pos_emb"].dtype)
            loss_acc = jnp.zeros((), jnp.float32)
            for t in range(n_micro + S - 1):
                m_idx = t - stage
                m_c = jnp.clip(m_idx, 0, n_micro - 1)
                s_m, k_m = seqs[m_c], masks[m_c]
                x_in = jnp.where(stage == 0, embed(s_m, k_m), buf)
                attn_ok = causal[None] & k_m[:, None, :]
                h = x_in
                block = jax.checkpoint(transformer_block) if remat else transformer_block
                for j in range(per):
                    h = block(jax.tree.map(lambda a: a[j], sl), h, attn_ok)
                hx = _layer_norm(p["final_ln"], h)
                lastpos = jnp.maximum(jnp.sum(k_m, axis=1) - 1, 0)
                h_last = jnp.take_along_axis(hx, lastpos[:, None, None], axis=1)[:, 0]
                mb_loss = _sampled_softmax(h_last @ p["out_proj"], p["item_emb"],
                                           tgts[m_c], negss[m_c])
                use = (stage == S - 1) & (m_idx >= 0) & (m_idx < n_micro)
                loss_acc = loss_acc + jnp.where(use, mb_loss, 0.0)
                buf = jax.lax.ppermute(h, model_axis, [(i, (i + 1) % S) for i in range(S)])
            return (loss_acc / n_micro).reshape(1, 1)

        def loss_fn(p):
            out = shard_map(
                local,
                mesh=mesh,
                in_specs=(specs, P(data_axis), P(data_axis), P(data_axis), P(data_axis)),
                out_specs=P(data_axis, model_axis),
                check_vma=False,
            )(p, seq, mask, tgt, negs)
            return jnp.sum(out) / dp

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return jax.jit(step, donate_argnums=(0, 1))


# --------------------------------------------------------------------------
# 3D parallelism: data x pipeline x tensor composed in one step
# --------------------------------------------------------------------------

def pp_tp_param_specs(params, pipe_axis: str = "pipe", model_axis: str = "model"):
    """Spec tree for :func:`stack_pipeline_params` output under combined
    pipeline + tensor parallelism: the stage axis shards over ``pipe`` and,
    within each stage, every layer tensor shards over ``model`` per
    :func:`_tp_layer_spec` (two leading stacked axes: stage, layer-in-stage).
    Embeddings and the loss head replicate on every device."""
    lspec = _tp_layer_spec(params["stage_layers"], model_axis)
    return {
        "item_emb": P(),
        "pos_emb": P(),
        "out_proj": P(),
        "final_ln": _ln_spec(),
        "stage_layers": jax.tree.map(
            lambda s: P(pipe_axis, None, *s), lspec,
            is_leaf=lambda x: isinstance(x, P),
        ),
    }


def make_pp_tp_sequence_step(mesh: Mesh, optimizer, *, n_micro: int,
                             sequence_parallel: bool = False, remat: bool = False,
                             data_axis: str = "data", pipe_axis: str = "pipe",
                             model_axis: str = "model"):
    """3D-parallel training step: batches shard over ``data``, transformer
    stages pipeline over ``pipe`` (GPipe microbatch schedule, ``ppermute``
    hops), and within every stage attention heads / FFN hidden shard over
    ``model`` (Megatron tensor parallelism, optional sequence parallelism).
    This is the composition a large cluster runs: tp inside a node where
    the interconnect is fastest, pp across clusters, dp across replicas — the reference
    (single GPU, SURVEY 2.10) has no analog.

    Params use :func:`stack_pipeline_params` + :func:`pp_tp_param_specs`;
    gradients for replicated leaves sum over all three axes through the
    shard_map transpose.  Returns ``step(params, opt_state, seq, mask, tgt,
    negs) -> (params, opt_state, loss)``."""
    S = mesh.shape[pipe_axis]
    mp = mesh.shape[model_axis]
    dp = mesh.shape[data_axis]
    sp = sequence_parallel and mp > 1

    def step(params, opt_state, seq, mask, tgt, negs):
        specs = pp_tp_param_specs(params, pipe_axis, model_axis)
        lead = np.shape(jax.tree.leaves(params["stage_layers"])[0])
        if lead[0] != S:
            raise ValueError(
                f"stage_layers has {lead[0]} stages but the mesh's "
                f"{pipe_axis!r} axis has {S} devices — call "
                f"stack_pipeline_params(params, {S})"
            )
        per = int(lead[1])

        def local(p, seq, mask, tgt, negs):
            stage = jax.lax.axis_index(pipe_axis)
            sl = jax.tree.map(lambda a: a[0], p["stage_layers"])  # my stage
            b_loc, L = seq.shape
            if b_loc % n_micro:
                raise ValueError(f"local batch {b_loc} not divisible by n_micro={n_micro}")
            if sp and L % mp:
                raise ValueError(f"sequence_parallel needs L ({L}) % mp ({mp}) == 0")
            mbs = b_loc // n_micro
            l_loc = L // mp if sp else L
            seqs = seq.reshape(n_micro, mbs, L)
            masks = mask.reshape(n_micro, mbs, L)
            tgts = tgt.reshape(n_micro, mbs)
            negss = negs.reshape(n_micro, mbs, -1)
            D = p["pos_emb"].shape[1]
            causal = jnp.tril(jnp.ones((L, L), bool))

            def embed(s, m):
                x = p["item_emb"][s] + p["pos_emb"][None, :L]
                x = jnp.where(m[:, :, None], x, 0.0)
                if sp:
                    mi = jax.lax.axis_index(model_axis)
                    x = jax.lax.dynamic_slice_in_dim(x, mi * l_loc, l_loc, axis=1)
                return x

            block = _tp_block
            if remat:
                block = jax.checkpoint(_tp_block, static_argnums=(3, 4))

            buf = jnp.zeros((mbs, l_loc, D), p["pos_emb"].dtype)
            loss_acc = jnp.zeros((), jnp.float32)
            for t in range(n_micro + S - 1):
                m_idx = t - stage
                m_c = jnp.clip(m_idx, 0, n_micro - 1)
                s_m, k_m = seqs[m_c], masks[m_c]
                x_in = jnp.where(stage == 0, embed(s_m, k_m), buf)
                attn_ok = causal[None] & k_m[:, None, :]
                h = x_in
                for j in range(per):
                    h = block(jax.tree.map(lambda a, j=j: a[j], sl), h,
                              attn_ok, model_axis, sp)
                hx = h
                if sp:
                    hx = jax.lax.all_gather(hx, model_axis, axis=1, tiled=True)
                hx = _layer_norm(p["final_ln"], hx)
                lastpos = jnp.maximum(jnp.sum(k_m, axis=1) - 1, 0)
                h_last = jnp.take_along_axis(hx, lastpos[:, None, None], axis=1)[:, 0]
                mb_loss = _sampled_softmax(h_last @ p["out_proj"], p["item_emb"],
                                           tgts[m_c], negss[m_c])
                use = (stage == S - 1) & (m_idx >= 0) & (m_idx < n_micro)
                loss_acc = loss_acc + jnp.where(use, mb_loss, 0.0)
                buf = jax.lax.ppermute(h, pipe_axis, [(i, (i + 1) % S) for i in range(S)])
            loss = _on_shard0(loss_acc / n_micro, model_axis)
            return loss.reshape(1, 1, 1)

        def loss_fn(p):
            out = shard_map(
                local,
                mesh=mesh,
                in_specs=(specs, P(data_axis), P(data_axis), P(data_axis), P(data_axis)),
                out_specs=P(data_axis, pipe_axis, model_axis),
                check_vma=False,
            )(p, seq, mask, tgt, negs)
            return jnp.sum(out) / dp

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return jax.jit(step, donate_argnums=(0, 1))
