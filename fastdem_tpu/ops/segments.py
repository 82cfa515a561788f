"""Segmented-array primitives: a sort-based substitute for scatter.

These helpers re-express "reduce by key into a dense table" as:

  sort by key  ->  segmented scan / head-tail picks  ->  searchsorted gather

which is all dense vector work (sort, log-depth scans, vectorized binary
search) with no duplicate-index scatter. The rasterizer's "sort" mode is
built on them (mapping/rasterize.py).

Key layout convention: arrays sorted ascending by (invalid, key, ...);
invalid entries sort to the tail and get key = num_keys sentinel.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp


def segment_heads(keys_sorted: jnp.ndarray, valid_sorted: jnp.ndarray) -> jnp.ndarray:
    """Boolean head flag per sorted position (first element of its run)."""
    changed = keys_sorted != jnp.roll(keys_sorted, 1)
    return valid_sorted & changed.at[0].set(True)


def segmented_scan(
    op: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    values: jnp.ndarray,
    heads: jnp.ndarray,
    reverse: bool = False,
) -> jnp.ndarray:
    """Inclusive segmented scan (Blelloch flag trick, log-depth).

    out[i] = op-reduction of values over the run containing i, from the
    segment start up to i (or from i to the segment end when ``reverse``).

    NOTE: invalid positions (sorted to the tail) are not delimited by a head
    flag, so in ``reverse`` mode they can flow into the last valid run —
    callers must pre-fill invalid positions with the op's identity
    (e.g. -inf for max) so leakage is harmless.
    """
    if reverse:
        # Suffix scan = prefix scan over reversed arrays; a segment's head
        # in reversed order is the original run's *last+1* boundary, i.e.
        # the element AFTER the original tail -> recompute flags from the
        # reversed key runs is cheaper done by the caller; here we derive:
        # reversed heads are original tails shifted.
        tails = jnp.roll(heads, -1).at[-1].set(True)
        rheads = tails[::-1]
        out = segmented_scan(op, values[::-1], rheads, reverse=False)
        return out[::-1]

    def comb(a, b):
        av, af = a
        bv, bf = b
        return (jnp.where(bf, bv, op(av, bv)), af | bf)

    out, _ = jax.lax.associative_scan(comb, (values, heads))
    return out


def dense_lookup(
    keys_sorted: jnp.ndarray,
    num_keys: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-dense-key positions into the sorted array.

    Returns (left, right, hit): left/right are the [num_keys] searchsorted
    bounds of each key's run; hit marks keys present. All gathers, no
    scatter.
    """
    queries = jnp.arange(num_keys, dtype=keys_sorted.dtype)
    left = jnp.searchsorted(keys_sorted, queries, side="left")
    right = jnp.searchsorted(keys_sorted, queries, side="right")
    return left, right, right > left


def gather_at(values_sorted: jnp.ndarray, pos: jnp.ndarray, hit: jnp.ndarray,
              fill=jnp.nan) -> jnp.ndarray:
    """values_sorted[pos] where hit else fill."""
    n = values_sorted.shape[0]
    v = values_sorted[jnp.clip(pos, 0, n - 1)]
    return jnp.where(hit, v, fill)
