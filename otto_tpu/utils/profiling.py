"""Tracing / profiling helpers.

The reference has no profiling at all (SURVEY §5.1 — only tqdm bars).  Here:

- :func:`trace` context manager wraps ``jax.profiler`` and writes a
  Perfetto-compatible trace directory
- :class:`StepTimer` measures per-step wall time up to
  ``jax.block_until_ready`` of the step's output
- :func:`device_memory_stats` snapshots live HBM usage
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np

from otto_tpu.logging_utils import get_logger

log = get_logger(__name__)


@contextlib.contextmanager
def trace(log_dir: str | Path):
    import jax

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", log_dir)


class StepTimer:
    """Rolling step timer; call ``stop(out)`` with the step's output so the
    time covers the device work, not only its dispatch."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, out=None) -> float:
        if out is not None:
            import jax

            jax.block_until_ready(out)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    def rate(self, items_per_step: int) -> float:
        return items_per_step / self.mean if self.times else float("nan")


def device_memory_stats() -> dict:
    import jax

    dev = jax.devices()[0]
    try:
        stats = dev.memory_stats()
        return {
            "bytes_in_use": stats.get("bytes_in_use"),
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "bytes_limit": stats.get("bytes_limit"),
        }
    except Exception:
        return {}
