"""Segmented-scan primitives.

Run-length sums over sorted key runs were first implemented as a global
``cumsum`` + subtraction, but a float32 cumsum over millions of elements
accumulates absolute error proportional to the *global* prefix magnitude
(~0.03 at 4e5), corrupting small run totals.  A segmented scan resets at each
run head, so rounding error is confined to the run itself.

The combine op ``(a, fa) ⊕ (b, fb) = (fb ? b : a + b, fa | fb)`` is
associative, which lets ``jax.lax.associative_scan`` parallelize it (log-depth
on the vector units).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def segmented_cumsum(values: jax.Array, head: jax.Array, axis: int = 0) -> jax.Array:
    """Inclusive cumsum along ``axis`` that restarts wherever ``head`` is True.

    values: float array; head: bool array with the same ndim as ``values``
    and broadcast-compatible shape (True marks the first element of each
    segment; head[0] need not be True — the scan starts a segment at position
    0 implicitly).
    """
    assert head.ndim == values.ndim, "head must have same ndim as values"
    flags = jnp.broadcast_to(head, values.shape)

    def combine(left, right):
        a, fa = left
        b, fb = right
        return jnp.where(fb, b, a + b), fa | fb

    out, _ = jax.lax.associative_scan(combine, (values, flags), axis=axis)
    return out


def segmented_propagate_first(values: jax.Array, head: jax.Array,
                              axis: int = 0) -> jax.Array:
    """Broadcast each segment's first value across the whole segment.

    Same segment convention as :func:`segmented_cumsum`.  The combine
    ``(a, fa) ⊕ (b, fb) = (fb ? b : a, fa | fb)`` is associative.
    """
    flags = jnp.broadcast_to(head, values.shape)

    def combine(left, right):
        a, fa = left
        b, fb = right
        return jnp.where(fb, b, a), fa | fb

    out, _ = jax.lax.associative_scan(combine, (values, flags), axis=axis)
    return out


def run_totals(values: jax.Array, head: jax.Array, axis: int = 0) -> jax.Array:
    """Per-position total of the containing run (same value across the run).

    Segmented cumsum, then each run's *last* prefix value is propagated
    backward over the run with a reversed propagate-first scan (in place of
    a full-width ``take_along_axis`` gather of ``seg[run_last]``).
    """
    seg = segmented_cumsum(values, head, axis=axis)
    flags = jnp.broadcast_to(head, values.shape)
    n = values.shape[axis]
    # reversed orientation: a run's last element becomes its segment's first;
    # its head flag is the *successor* head in the original orientation
    succ_head = jnp.concatenate(
        [
            jax.lax.slice_in_dim(flags, 1, n, axis=axis),
            jnp.full_like(jax.lax.slice_in_dim(flags, 0, 1, axis=axis), True),
        ],
        axis=axis,
    )
    rev = segmented_propagate_first(
        jnp.flip(seg, axis=axis), jnp.flip(succ_head, axis=axis), axis=axis
    )
    return jnp.flip(rev, axis=axis)
