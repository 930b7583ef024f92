"""Device mesh construction and sharding helpers.

The reference has no distributed layer at all (SURVEY §2.10: single GPU, no
NCCL/MPI; scale-out faked with file chunking).  This module is the device
communication backend it lacked: a named ``jax.sharding.Mesh`` with
``('data', 'model')`` axes; collectives are expressed with ``shard_map`` +
``psum``/``all_gather`` and lowered by XLA onto the interconnect.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from otto_tpu.config import MeshConfig


def make_mesh(config: MeshConfig = MeshConfig(), devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    mp = max(config.model_parallel, 1)
    dp = config.data_parallel if config.data_parallel > 0 else n // mp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} does not match {n} devices")
    arr = np.asarray(devices).reshape(dp, mp)
    return Mesh(arr, (config.data_axis, config.model_axis))


def make_mesh3d(data_parallel: int, pipeline_parallel: int, tensor_parallel: int,
                devices=None,
                axes: tuple[str, str, str] = ("data", "pipe", "model")) -> Mesh:
    """Three-axis mesh for composed data x pipeline x tensor parallelism
    (parallel/model_parallel.py::make_pp_tp_sequence_step).  Axis order puts
    tensor parallelism innermost — on hardware the fastest-varying mesh axis
    maps to the tightest interconnect neighborhood, where tp's per-layer
    psums live."""
    devices = list(devices if devices is not None else jax.devices())
    n = data_parallel * pipeline_parallel * tensor_parallel
    if n > len(devices):
        raise ValueError(
            f"mesh {data_parallel}x{pipeline_parallel}x{tensor_parallel} "
            f"needs {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(data_parallel, pipeline_parallel, tensor_parallel)
    return Mesh(arr, axes)


def init_distributed() -> None:
    """Multi-host process-group init (jax.distributed over DCN).  No-op when
    running single-process (the common case in tests and on one host)."""
    try:
        if jax.process_count() > 1:
            return  # already initialized by the launcher
        jax.distributed.initialize()
    except Exception:  # single-process / unsupported platform
        pass


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh, axis: str = "model") -> NamedSharding:
    """Shard the leading (row) dimension across ``axis``."""
    return NamedSharding(mesh, P(axis))


def batch_sharded(mesh: Mesh, axis: str = "data") -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def shard_rows(mesh: Mesh, array, axis: str = "model"):
    """Place an array row-sharded on the mesh (pads rows to a multiple of the
    axis size; callers must track the true row count)."""
    import jax.numpy as jnp

    n = array.shape[0]
    size = mesh.shape[axis]
    pad = (-n) % size
    if pad:
        array = jnp.concatenate([jnp.asarray(array), jnp.zeros((pad, *array.shape[1:]), array.dtype)])
    return jax.device_put(jnp.asarray(array), row_sharded(mesh, axis))


def host_shard_sessions(n_sessions: int, process_index: int | None = None,
                        process_count: int | None = None):
    """Multi-host input sharding: the contiguous session range this host
    feeds (SURVEY §5.8 — input pipeline keyed by jax.process_index)."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    per = -(-n_sessions // pc)
    lo = pi * per
    hi = min(lo + per, n_sessions)
    return np.arange(lo, hi)
