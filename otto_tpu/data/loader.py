"""Prefetching host->device batch pipeline.

The reference streams training pairs through the Merlin dataloader, a
GPU-resident cuDF parquet reader (reference:
src/matrix_factorization/torch_trainer.py:13-14,315-318).  The JAX
equivalent is a host input pipeline: batches are sliced from host arrays and
shipped to the device on a background thread, double-buffered, so the
transfer overlaps the previous step's compute (JAX dispatch is async — the
train step only blocks when its inputs haven't landed).  With ``sharding``
each batch lands data-parallel across a mesh axis; multi-host runs combine
this with :func:`otto_tpu.parallel.mesh.host_shard_sessions` so each process
feeds its own session range.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

_DONE = object()


class BatchLoader:
    """Iterate fixed-shape device-resident batches of ``arrays``.

    - ``order``: explicit row order (e.g. an epoch permutation); default
      sequential.  The remainder batch is dropped when ``drop_remainder``
      (matching the reference trainer's loop) or wrapped to full size.
    - ``sharding``: a ``jax.sharding.Sharding`` each batch is placed with
      (e.g. ``NamedSharding(mesh, P('data'))``).
    - ``prefetch``: queue depth; 2 = classic double buffering.
    - ``transform``: host-side callable applied to each batch tuple on the
      worker thread before the device put (e.g. a lookup-table gather that
      would be too large to materialize for the whole epoch); returns the
      tuple of arrays to ship.

    Usable as a one-shot iterator; ``close()`` (or exhausting it) stops the
    worker.  Exceptions in the worker re-raise at the consuming site.
    """

    def __init__(self, arrays, batch_size: int, *, order: np.ndarray | None = None,
                 sharding=None, prefetch: int = 2, drop_remainder: bool = True,
                 transform=None):
        import jax

        self._transform = transform

        self._arrays = tuple(arrays)
        n = len(self._arrays[0])
        for a in self._arrays[1:]:
            if len(a) != n:
                raise ValueError("arrays must share their leading dimension")
        self._order = np.arange(n) if order is None else np.asarray(order)
        n = len(self._order)
        self._B = batch_size
        if drop_remainder:
            self._n_batches = max(n // batch_size, 1) if n else 0
        else:
            self._n_batches = -(-n // batch_size) if n else 0
        self._put = (lambda x: jax.device_put(x, sharding)) if sharding is not None \
            else (lambda x: jax.numpy.asarray(x))
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            B = self._B
            n = len(self._order)
            for i in range(self._n_batches):
                sel = self._order[i * B : (i + 1) * B]
                if len(sel) < B:  # wrap to keep shapes static (one compile);
                    # tile as often as needed when B exceeds the epoch size
                    reps = -(-(B - len(sel)) // max(n, 1))
                    sel = np.concatenate([sel] + [self._order] * reps)[:B]
                host = tuple(a[sel] for a in self._arrays)
                if self._transform is not None:
                    host = self._transform(*host)
                batch = tuple(self._put(a) for a in host)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._q.put(_DONE)
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            try:
                self._q.put(e, timeout=1.0)
            except queue.Full:
                pass

    def __len__(self) -> int:
        return self._n_batches

    def __iter__(self):
        try:
            while True:
                item = self._q.get()
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self.close()

    def close(self):
        self._stop.set()
        # drain so a blocked worker can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
