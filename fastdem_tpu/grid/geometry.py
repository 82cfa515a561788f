"""Grid geometry: world position <-> cell index math for 2.5D elevation maps.

Vectorized re-expression of the nanoGrid geometry contract used by FastDEM
(see reference call sites: /root/reference/fastdem/src/raycasting.cpp:57-77,
/root/reference/fastdem/src/pcd_convert.cpp:333-349,
/root/reference/fastdem/include/fastdem/bridge/ros/impl.hpp:42-46).

Conventions (identical to ETH grid_map / nanoGrid):
  * The map is a dense ``rows x cols`` grid of square cells of side
    ``resolution`` meters, centered on ``position`` (world x, y).
  * Row index increases toward -x, column index increases toward -y:
      row = floor((position.x + length.x/2 - p.x) / resolution)
      col = floor((position.y + length.y/2 - p.y) / resolution)
  * The center of cell (r, c) is at
      x = position.x + length.x/2 - (r + 0.5) * resolution
      y = position.y + length.y/2 - (c + 0.5) * resolution

Deviation from the reference: there is NO circular buffer. Layers are always
stored world-aligned (``start_index`` is logically always (0, 0)); the LOCAL
mode ``move()`` is implemented as ``jnp.roll`` + masked invalidation (see
``fastdem_tpu.grid.gridmap.move``). A whole-grid fused roll/where pass
removes index-wrap arithmetic from every kernel, which is what lets
rasterization/estimation compile to plain vector code.

``GridGeometry`` is a hashable, frozen dataclass so it can be passed as a
static argument to ``jax.jit``; per-frame dynamic state (the map center) is a
traced array carried in ``GridMapState``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    """Static grid shape/resolution. Hashable: usable as a jit static arg.

    Attributes:
      rows: number of cells along the row axis (world -x direction).
      cols: number of cells along the column axis (world -y direction).
      resolution: cell side length in meters.
    """

    rows: int
    cols: int
    resolution: float

    @staticmethod
    def from_length(width: float, height: float, resolution: float) -> "GridGeometry":
        """Create a geometry covering ``width x height`` meters.

        Mirrors nanogrid::GridMap::setGeometry(Length(width, height), res):
        the cell count is rounded so the map covers at least the requested
        extent (ceil, like grid_map).
        """
        rows = max(1, int(np.ceil(round(width / resolution, 6))))
        cols = max(1, int(np.ceil(round(height / resolution, 6))))
        return GridGeometry(rows=rows, cols=cols, resolution=float(resolution))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.cols)

    @property
    def num_cells(self) -> int:
        return self.rows * self.cols

    @property
    def length(self) -> Tuple[float, float]:
        """Map extent in meters (x-extent, y-extent)."""
        return (self.rows * self.resolution, self.cols * self.resolution)

    # ------------------------------------------------------------------
    # Vectorized world <-> index transforms. All take/return jnp arrays and
    # are safe to call inside jit. ``position`` is the traced map center.
    # ------------------------------------------------------------------

    def origin(self, position: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Top-left map corner (max-x, max-y edge) in world coordinates."""
        ox = position[0] + 0.5 * self.rows * self.resolution
        oy = position[1] + 0.5 * self.cols * self.resolution
        return ox, oy

    def index_of(
        self, position: jnp.ndarray, xy: jnp.ndarray
    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Map world points to integer cell indices.

        Args:
          position: f32[2] map center.
          xy: f32[..., 2] world points.

        Returns:
          (row i32[...], col i32[...], inside bool[...]).
        """
        ox, oy = self.origin(position)
        r = jnp.floor((ox - xy[..., 0]) / self.resolution).astype(jnp.int32)
        c = jnp.floor((oy - xy[..., 1]) / self.resolution).astype(jnp.int32)
        inside = (r >= 0) & (r < self.rows) & (c >= 0) & (c < self.cols)
        return r, c, inside

    def cell_id_of(
        self, position: jnp.ndarray, xy: jnp.ndarray
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Flattened cell ids (r * cols + c); out-of-map points get id
        ``num_cells`` (a dummy overflow slot for scatter ops)."""
        r, c, inside = self.index_of(position, xy)
        flat = r * self.cols + c
        return jnp.where(inside, flat, self.num_cells), inside

    def position_of(
        self, position: jnp.ndarray, row: jnp.ndarray, col: jnp.ndarray
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """World coordinates of cell centers (inverse of ``index_of``)."""
        ox, oy = self.origin(position)
        x = ox - (row.astype(jnp.float32) + 0.5) * self.resolution
        y = oy - (col.astype(jnp.float32) + 0.5) * self.resolution
        return x, y

    def cell_centers(self, position: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """World x/y coordinates of all cell centers, shape [rows, cols]."""
        rr = jnp.arange(self.rows, dtype=jnp.float32)[:, None]
        cc = jnp.arange(self.cols, dtype=jnp.float32)[None, :]
        ox, oy = self.origin(position)
        x = ox - (rr + 0.5) * self.resolution
        y = oy - (cc + 0.5) * self.resolution
        return jnp.broadcast_to(x, self.shape), jnp.broadcast_to(y, self.shape)

    def is_inside(self, position: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
        """True for world points inside the map bounds."""
        _, _, inside = self.index_of(position, xy)
        return inside
