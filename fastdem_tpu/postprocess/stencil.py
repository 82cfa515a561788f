"""Window-stencil helpers: neighborhood offset sets + shifted-stack gather.

The reference iterates precomputed neighborhoods
(nanogrid region(radius)/region(Size) + neighbors(), SURVEY.md sec. 2.3);
here the equivalent is a stacked gather of shifted copies: for a window of
K offsets over an [H, W] layer, build a [K, H, W] tensor (edges padded with
NaN so border cells simply see fewer valid neighbors, matching the
reference's bounds-checked iteration). XLA fuses the K shifted slices into
vector loads; K is small (9..49) for every configured radius.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=64)
def disk_offsets(radius_m: float, resolution: float) -> Tuple[Tuple[int, int], ...]:
    """Offsets (dr, dc) whose center distance is within ``radius_m``
    (nanogrid region(radius) semantics, incl. the center cell)."""
    r_cells = int(np.floor(radius_m / resolution + 1e-6))
    out: List[Tuple[int, int]] = []
    for dr in range(-r_cells, r_cells + 1):
        for dc in range(-r_cells, r_cells + 1):
            d = np.hypot(dr, dc) * resolution
            if d <= radius_m + 1e-6:
                out.append((dr, dc))
    return tuple(out)


@lru_cache(maxsize=16)
def square_offsets(k: int, include_center: bool = True) -> Tuple[Tuple[int, int], ...]:
    """k x k window offsets (nanogrid region(Size(k, k)))."""
    h = k // 2
    return tuple(
        (dr, dc)
        for dr in range(-h, h + 1)
        for dc in range(-h, h + 1)
        if include_center or (dr, dc) != (0, 0)
    )


def offset_distances_sq(
    offsets: Sequence[Tuple[int, int]], resolution: float
) -> np.ndarray:
    """Squared metric distance per offset (neighbors().dist_sq)."""
    o = np.asarray(offsets, dtype=np.float32)
    return (o[:, 0] ** 2 + o[:, 1] ** 2) * resolution * resolution


def window_stack(
    a: jnp.ndarray, offsets: Sequence[Tuple[int, int]], fill: float = np.nan
) -> jnp.ndarray:
    """[K, H, W] where out[k, i, j] = a[i + dr_k, j + dc_k] (fill outside)."""
    H, W = a.shape
    R = max(max(abs(dr), abs(dc)) for dr, dc in offsets)
    padded = jnp.pad(a, ((R, R), (R, R)), constant_values=fill)
    return jnp.stack(
        [padded[R + dr : R + dr + H, R + dc : R + dc + W] for dr, dc in offsets]
    )
