"""Model-parallelism walkthrough: train the session transformer under every
sharding strategy the framework supports and confirm they optimize the same
objective.

Strategies (all on one 8-virtual-device mesh; see DESIGN.md §6):

- dp     — data parallel (params replicated, psum grads)
- tp     — Megatron tensor parallel (heads + FFN hidden sharded)
- tp+sp  — tensor + sequence parallel (L-sharded LN/residual regions,
           all_gather/psum_scatter pairs)
- pp     — GPipe pipeline (layer stages over ppermute, microbatches)
- ep     — expert-parallel MoE recommender (one expert group per shard)

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
     python examples/08_model_parallelism.py
"""

import sys as _sys, pathlib as _pathlib
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
import optax

from otto_tpu.config import MeshConfig
from otto_tpu.data.synthetic import synthetic_events
from otto_tpu.models.sequence import _training_examples, init_params
from otto_tpu.parallel.data_parallel import make_dp_sequence_step
from otto_tpu.parallel.expert_parallel import (
    init_moe_recommender,
    make_ep_moe_step,
    moe_recommender_specs,
)
from otto_tpu.parallel.mesh import make_mesh
from otto_tpu.parallel.model_parallel import (
    make_pp_sequence_step,
    make_tp_sequence_step,
    pp_param_specs,
    shard_params,
    stack_pipeline_params,
    tp_param_specs,
)

V, D, L, B, NEG, STEPS = 2000, 32, 16, 256, 8, 30

store = synthetic_events(n_sessions=4000, n_aids=V, mean_length=8.0, seed=0)
seqs, masks, tgts = _training_examples(store, L, V)
print(f"{len(tgts)} training examples from {store.n_sessions} sessions")

mesh = make_mesh(MeshConfig(data_parallel=2, model_parallel=4))
print(f"mesh: {dict(mesh.shape)}")

params0 = init_params(jax.random.PRNGKey(0), V, D, D, architecture="transformer",
                      max_len=L, n_layers=4, n_heads=8)
opt = optax.adam(3e-3)
rng = np.random.default_rng(0)
batches = []
for _ in range(STEPS):
    sel = rng.integers(0, len(tgts), B)
    batches.append((jnp.asarray(seqs[sel]), jnp.asarray(masks[sel]),
                    jnp.asarray(tgts[sel]),
                    jnp.asarray(rng.integers(0, V, (B, NEG)).astype(np.int32))))


def fresh(tree):
    return jax.tree.map(lambda a: jnp.array(a, copy=True), tree)


def train(name, step, p):
    st = opt.init(p)
    first = last = None
    for i, batch in enumerate(batches):
        p, st, loss = step(p, st, *batch)
        if i == 0:
            first = float(loss)
        last = float(loss)
    print(f"{name:8s} loss {first:.4f} -> {last:.4f}")
    return last


results = {}

results["dp"] = train("dp", make_dp_sequence_step(mesh, opt), fresh(params0))

p = shard_params(mesh, fresh(params0), tp_param_specs(params0))
results["tp"] = train("tp", make_tp_sequence_step(mesh, opt), p)

p = shard_params(mesh, fresh(params0), tp_param_specs(params0))
results["tp+sp"] = train(
    "tp+sp", make_tp_sequence_step(mesh, opt, sequence_parallel=True), p)

stacked = stack_pipeline_params(params0, 4)
p = shard_params(mesh, fresh(stacked), pp_param_specs(stacked))
results["pp"] = train("pp", make_pp_sequence_step(mesh, opt, n_micro=4), p)

from otto_tpu.parallel.data_parallel import make_zero_sequence_step, zero_init
from otto_tpu.parallel.mesh import make_mesh3d
from otto_tpu.parallel.model_parallel import (
    make_pp_tp_sequence_step, pp_tp_param_specs)

# ZeRO-1: same math as dp with the optimizer state sharded 8 ways
p = fresh(params0)
zstep = make_zero_sequence_step(mesh, opt)
st = zero_init(mesh, opt, p)
first = last = None
for i, batch in enumerate(batches):
    p, st, loss = zstep(p, st, *batch)
    first = float(loss) if i == 0 else first
    last = float(loss)
print(f"{'zero-1':8s} loss {first:.4f} -> {last:.4f}")
results["zero"] = last

# 3D: data(2) x pipeline(2) x tensor(2) composed in one step
mesh3 = make_mesh3d(2, 2, 2)
stacked3 = stack_pipeline_params(params0, 2)
p = shard_params(mesh3, fresh(stacked3), pp_tp_param_specs(stacked3))
results["3d"] = train(
    "3d", make_pp_tp_sequence_step(mesh3, opt, n_micro=4, sequence_parallel=True), p)

moe0 = init_moe_recommender(jax.random.PRNGKey(1), V, D, 4 * D, 8)
p = shard_params(mesh, fresh(moe0), moe_recommender_specs())
ep_step = make_ep_moe_step(mesh, opt, capacity=B)
ep_batches = [(s, m.astype(jnp.float32), t, n) for s, m, t, n in batches]
st = opt.init(p)
first = last = None
for i, batch in enumerate(ep_batches):
    p, st, loss = ep_step(p, st, *batch)
    if i == 0:
        first = float(loss)
    last = float(loss)
print(f"{'ep(moe)':8s} loss {first:.4f} -> {last:.4f}")
results["ep"] = last

# dp/tp/tp+sp/pp/zero/3d run the *same* model and should land in the same band
vals = [results[k] for k in ("dp", "tp", "tp+sp", "pp", "zero", "3d")]
spread = max(vals) - min(vals)
print(f"\ndp/tp/sp/pp/zero/3d final-loss spread: {spread:.4f} (same objective, same init)")
assert spread < 0.05, "parallel strategies diverged on identical training"
print("OK: every parallelism strategy optimizes the same objective")
