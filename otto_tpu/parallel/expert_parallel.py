"""Expert parallelism: a mixture-of-experts FFN block sharded one expert
group per ``model``-axis device.

The reference has nothing like this (SURVEY §2.10); it completes the
framework's parallelism inventory (dp / tp / sp / pp / ep).  The block is a
drop-in replacement for a transformer FFN or a ranking-tower layer: top-1
gating, fixed per-expert capacity, dense one-hot dispatch/combine matmuls
(matmul-friendly — the classic Shazeer formulation), and a single ``psum`` to
combine expert outputs.

The MoE core (gating/dispatch/combine) lives in :mod:`otto_tpu.ops.moe`
and is shared with the transformer's ``moe_experts`` FFN; this module adds
the expert-parallel pooled-session recommender and its training step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from otto_tpu.parallel.model_parallel import _on_shard0, _sampled_softmax


from otto_tpu.ops.moe import init_moe, moe_apply, moe_param_specs  # noqa: F401
# (core moved to ops/moe.py so the transformer can use the MoE FFN without an
# import cycle; this module keeps the expert-parallel recommender + step)


def init_moe_recommender(key, n_aids: int, dim: int, hidden: int, n_experts: int):
    """Pooled-session MoE next-item scorer: mean-pooled item embeddings ->
    residual MoE FFN -> sampled-softmax against the tied item table."""
    ke, km = jax.random.split(key)
    return {
        "item_emb": jax.random.normal(ke, (n_aids + 1, dim)) * 0.05,
        "moe": init_moe(km, dim, hidden, n_experts),
    }


def moe_recommender_specs(model_axis: str = "model"):
    return {"item_emb": P(), "moe": moe_param_specs(model_axis)}


def make_ep_moe_step(mesh: Mesh, optimizer, *, capacity: int,
                     data_axis: str = "data", model_axis: str = "model"):
    """Expert-parallel training step for the pooled-session MoE recommender:
    batch shards over ``data``, experts shard over ``model``; grads flow
    through the psum-combine via the shard_map transpose (see
    parallel/model_parallel.py module docstring).

    Returns ``step(params, opt_state, seq, mask, tgt, negs)``."""
    dp = mesh.shape[data_axis]

    def step(params, opt_state, seq, mask, tgt, negs):
        specs = moe_recommender_specs(model_axis)

        def local(p, seq, mask, tgt, negs):
            emb = p["item_emb"][seq] * mask[:, :, None]  # [B, L, D]
            denom = jnp.maximum(jnp.sum(mask, axis=1, keepdims=True), 1)
            pooled = jnp.sum(emb, axis=1) / denom  # [B, D]
            h = pooled + moe_apply(p["moe"], pooled, capacity=capacity,
                                   model_axis=model_axis)
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
