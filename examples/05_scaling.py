"""Weak-scaling study over the visible devices (virtual CPU devices or GPUs).

Measures per-step time of the two multi-chip training paths as the mesh
grows with the workload (weak scaling: problem size per device fixed):

- data-parallel ranker step (params replicated, batch sharded over `data`,
  psum gradient reduction)
- row-sharded SGNS embedding step (table sharded over `model`, all-to-all
  style gathers)

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
     python examples/05_scaling.py

On virtual CPU devices the absolute numbers only demonstrate that the
collective programs compile/execute and that step time stays ~flat as
devices x batch grow together; run it on the GPUs (without the two
variables) for interconnect scaling.
"""

import sys as _sys, pathlib as _pathlib
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import time

import jax

import jax.numpy as jnp
import numpy as np
import optax

from otto_tpu.config import MeshConfig
from otto_tpu.models.ranker import init_tower
from otto_tpu.parallel.data_parallel import make_dp_ranker_step
from otto_tpu.parallel.mesh import make_mesh, shard_rows
from otto_tpu.parallel.sharded_embedding import make_sharded_sgns_step


def time_step(fn, state, args, iters=20):
    """fn(*state, *args) -> (new_state..., loss); state is donated, so thread
    it through the loop."""
    n_state = len(state)

    def once(state):
        out = fn(*state, *args)
        return out[:n_state], out[-1]

    state, loss = once(state)  # compile + warm
    jax.block_until_ready(loss)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, loss = once(state)
    jax.block_until_ready(loss)
    return (time.perf_counter() - t0) / iters


def dp_ranker_row(n_dev, per_dev_batch=64, C=64, F=52):
    mesh = make_mesh(MeshConfig(data_parallel=n_dev, model_parallel=1),
                     devices=jax.devices()[:n_dev])
    rng = np.random.default_rng(0)
    B = per_dev_batch * n_dev
    params = init_tower(jax.random.PRNGKey(0), F, (256, 256, 128))
    opt = optax.adamw(1e-3)
    step = make_dp_ranker_step(mesh, opt)
    state = (params, opt.init(params))
    args = (
        jnp.asarray(rng.normal(size=(B, C, F)).astype(np.float32)),
        jnp.asarray((rng.random((B, C)) < 0.2).astype(np.int8)),
        jnp.ones((B, C), bool),
        jax.random.PRNGKey(1),
    )
    dt = time_step(step, state, args)
    return B * C / dt, dt


def sgns_row(n_dev, rows_per_dev=65536, dim=32, per_dev_batch=2048, neg=8):
    mesh = make_mesh(MeshConfig(data_parallel=1, model_parallel=n_dev),
                     devices=jax.devices()[:n_dev])
    rng = np.random.default_rng(0)
    N = rows_per_dev * n_dev
    B = per_dev_batch * n_dev
    w_in = shard_rows(mesh, rng.uniform(-0.1, 0.1, (N, dim)).astype(np.float32))
    w_out = shard_rows(mesh, np.zeros((N, dim), np.float32))
    acc_in = shard_rows(mesh, np.zeros((N, dim), np.float32))
    acc_out = shard_rows(mesh, np.zeros((N, dim), np.float32))
    step = make_sharded_sgns_step(mesh, n_negatives=neg)
    c = jnp.asarray(rng.integers(0, N, B).astype(np.int32))
    x = jnp.asarray(rng.integers(0, N, B).astype(np.int32))
    negs = jnp.asarray(rng.integers(0, N, (B, neg)).astype(np.int32))
    lr = jnp.float32(0.05)
    dt = time_step(step, (w_in, w_out, acc_in, acc_out), (c, x, negs, lr))
    return B / dt, dt


if __name__ == "__main__":
    n_avail = len(jax.devices())
    print(f"backend={jax.default_backend()}, devices={n_avail}")
    print("\nweak scaling — data-parallel ranker (fixed 64 sessions x 64 cand/device)")
    print(f"{'devices':>8} {'step ms':>10} {'candidates/s':>15} {'efficiency':>11}")
    base = None
    for n in (1, 2, 4, 8):
        if n > n_avail:
            break
        rate, dt = dp_ranker_row(n)
        base = base or rate / n
        print(f"{n:>8} {dt*1e3:>10.2f} {rate:>15,.0f} {rate / (base*n):>10.1%}")

    print("\nweak scaling — row-sharded SGNS (fixed 64k rows + 2048 pairs/device)")
    print(f"{'devices':>8} {'step ms':>10} {'pairs/s':>15} {'efficiency':>11}")
    base = None
    for n in (1, 2, 4, 8):
        if n > n_avail:
            break
        rate, dt = sgns_row(n)
        base = base or rate / n
        print(f"{n:>8} {dt*1e3:>10.2f} {rate:>15,.0f} {rate / (base*n):>10.1%}")
