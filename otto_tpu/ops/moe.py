"""Mixture-of-experts FFN core: top-1 gating, fixed per-expert capacity,
dense one-hot dispatch/combine matmuls (matmul-friendly — the classic Shazeer
formulation).

Used two ways:

- single-device (``model_axis=None``): every expert lives locally; this is
  the dense-correctness form the transformer uses when
  ``SequenceModelConfig.moe_experts > 0``.
- expert-parallel (``model_axis='model'`` inside ``shard_map``): the leading
  expert dimension is sharded one group per device and outputs combine with
  one ``psum`` (see parallel/expert_parallel.py; when tokens are sharded
  over the same axis the dispatch rides ``all_to_all`` instead — the math
  is identical).

Over-capacity tokens pass through with zero expert contribution (the
standard capacity-factor drop); masked (padding) tokens never win a
capacity slot.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def init_moe(key, dim: int, hidden: int, n_experts: int):
    kg, k1, k2 = jax.random.split(key, 3)
    s = (1.0 / dim) ** 0.5
    return {
        "wg": jax.random.normal(kg, (dim, n_experts)) * s,
        "w1": jax.random.normal(k1, (n_experts, dim, hidden)) * s,
        "b1": jnp.zeros((n_experts, hidden)),
        "w2": jax.random.normal(k2, (n_experts, hidden, dim)) * (1.0 / hidden) ** 0.5,
        "b2": jnp.zeros((dim,)),
    }


def moe_param_specs(model_axis: str = "model"):
    from jax.sharding import PartitionSpec as P

    return {"wg": P(), "w1": P(model_axis), "b1": P(model_axis),
            "w2": P(model_axis), "b2": P()}


def moe_apply(p, x, *, capacity: int, model_axis: str | None = "model",
              token_mask=None):
    """MoE FFN over tokens ``x`` [T, D].

    With ``model_axis`` set this must run inside shard_map with the expert
    dimension sharded (p["w1"] etc. hold the local ``E/mp`` experts) and
    ``x`` replicated across that axis; with ``model_axis=None`` all experts
    are local and no collective is issued.  ``token_mask`` [T] bool marks
    real tokens — padding never occupies an expert's capacity.

    Each local expert takes its top-``capacity`` assigned tokens by gate
    score (a [C]-row gather — top_k slots are distinct, so the combining
    scatter-add has no collisions), applies its FFN, and scatters back
    weighted by the gate probability.  Empty slots carry weight 0 and add
    nothing.  (A dense one-hot dispatch matmul is the classic formulation
    but materializes [C, T] — O(GB) per expert at transformer token counts;
    the gather/scatter form is O(C*D).)"""
    T, D = x.shape
    capacity = min(capacity, T)
    e_loc = p["w1"].shape[0]
    m = jax.lax.axis_index(model_axis) if model_axis is not None else 0
    gate = jax.nn.softmax(x @ p["wg"], axis=1)  # [T, E] (global expert count)
    assign = jnp.argmax(gate, axis=1)
    top_p = jnp.max(gate, axis=1)
    if token_mask is not None:
        top_p = jnp.where(token_mask, top_p, 0.0)
    out = jnp.zeros_like(x)
    for e in range(e_loc):
        ge = m * e_loc + e
        score = jnp.where((assign == ge) & (top_p > 0), top_p, -1.0)
        val, idx = jax.lax.top_k(score, capacity)  # this expert's tokens
        w = jnp.where(val > 0, val, 0.0)  # gate weight; 0 for empty slots
        xe = jnp.take(x, idx, axis=0)  # [C, D] dispatch gather
        he = jax.nn.gelu(xe @ p["w1"][e] + p["b1"][e]) @ p["w2"][e]
        out = out.at[idx].add(he * w[:, None])  # combine
    if model_axis is not None:
        out = jax.lax.psum(out, model_axis)
    return out + p["b2"]
