"""Ghost-obstacle removal via log-odds visibility (polar raycast).

Data-parallel reformulation of the reference DDA raycaster
(/root/reference/fastdem/src/raycasting.cpp). The sequential per-ray grid
walk that records the minimum ray height per traversed cell (:46-139) is
replaced by a POLAR reduction that exploits the single shared ray origin:

  A ray's height at 2D distance d from the sensor is
      h(d) = origin_z + slope * d,   slope = dz / |dxy|,
  so the minimum height over all rays alive at distance d is
      h_min(d) = origin_z + d * min(slope of rays with exit_dist >= d).

  1. One N-sized scatter-min of ray slopes into an (azimuth bin, exit
     range bin) polar grid.
  2. A dense reverse cumulative min along the range axis turns that into
     min-slope-of-rays-alive-at-r for every polar bin; a 2-bin range
     window min folds in rays that die inside a grid cell.
  3. Cartesian resampling: each cell reads h at its (azimuth, range); the
     cell's angular footprint (wider near the sensor) is covered by
     per-range-column power-of-two azimuth smears (static masks); with
     the exact-window fold (default) the residual window rides the field
     too, so the min over the exact span is ONE lookup per cell.

The only irregular-memory ops are one N-sized scatter and one
cell-count-sized gather; everything else is dense elementwise/roll work
that XLA fuses. The naive formulation (ray_min_height_sampled) scatters
~2*(rows+cols) samples per ray instead.

Semantics parity (file:line refer to raycasting.cpp):
  * observed evidence: +log_odds_observed per downsampled point in the
    cell, clamped at log_odds_max (:165-169). Sequential clamped addition
    of a positive constant == add-then-clamp, and the per-cell multiplicity
    is the distinct-z-voxel count provided by the rasterizer (the reference
    feeds the raycaster a voxel-downsampled scan, src/fastdem.cpp:156-158).
  * ray min heights: the reference records the height at each cell's exit
    (the in-cell minimum for downward rays, :116-117); the polar field
    approximates it within half a range bin (res/4 vertically scaled by
    the slope) and one azimuth bin. Unlike the reference (one arbitrary
    representative ray per voxel), ALL downward rays contribute — a strict
    refinement of the min.
  * resolveGhostCells (:188-214) and the origin-inside / empty-scan gates
    (:218-249) are unchanged; clearing NaNs every layer then marks
    ghost_removal = 1.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fastdem_tpu.config.config import RaycastingConfig
from fastdem_tpu.grid.geometry import GridGeometry
from fastdem_tpu.grid.gridmap import GridMapState, layers

_INF = jnp.inf

# Azimuth half-width factor for a cell's angular footprint: half_w =
# atan2(AZ_HALF_WIDTH * res, d). 0.5 = inscribed width (may miss corner
# crossings), 0.707 = circumscribed (counts rays that miss the cell).
# 0.5 measured closest to the reference DDA's crossing set (envelope
# diag: over-ghosting from >0.5 factors dominates the log-odds
# deviation); resample_indices and _column_windows MUST use the same
# value (the exact_window fold relies on it).
AZ_HALF_WIDTH = 0.5


def layer_fills() -> Dict[str, float]:
    """Raycasting layers (postprocess/raycasting.hpp:26-30); created at init
    since the layer set is static under jit."""
    return {
        layers.ghost_removal: np.nan,
        layers.raycasting: np.nan,
        layers.visibility_logodds: np.nan,
    }


def _clip_exit(
    geom: GridGeometry,
    position: jnp.ndarray,
    origin: jnp.ndarray,
    ends: jnp.ndarray,
):
    """Liang-Barsky: t of map-rect exit along origin->end, clamped to [0,1]
    (the DDA stops at the endpoint or the map edge, raycasting.cpp:110-137)."""
    half_x = 0.5 * geom.rows * geom.resolution
    half_y = 0.5 * geom.cols * geom.resolution
    lo = jnp.stack([position[0] - half_x, position[1] - half_y])
    hi = jnp.stack([position[0] + half_x, position[1] + half_y])
    d = ends[:, :2] - origin[:2]
    safe_d = jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
    t_lo = (lo - origin[:2]) / safe_d
    t_hi = (hi - origin[:2]) / safe_d
    t_exit = jnp.min(jnp.maximum(t_lo, t_hi), axis=1)
    return jnp.clip(t_exit, 0.0, 1.0)


def polar_dims(
    geom: GridGeometry,
    num_azimuth: int,
    range_bin_factor: float,
    max_range: Optional[float] = None,
):
    """Polar grid dims. ``max_range`` bounds the range axis: without it the
    field spans the map DIAGONAL, which explodes on large global maps
    (200 m @ 0.1 m -> [5657, 2048]); real sensors are range-limited and
    the pipeline derives the bound from the point filter's range_max."""
    A = num_azimuth
    dr = geom.resolution * range_bin_factor
    diag = math.hypot(geom.rows, geom.cols) * geom.resolution
    extent = diag if max_range is None else min(diag, max_range)
    R = int(math.ceil(extent / dr)) + 2
    return A, R, dr


def polar_scatter_spec(
    geom: GridGeometry,
    position: jnp.ndarray,
    xyz: jnp.ndarray,
    ray_mask: jnp.ndarray,
    sensor_origin: jnp.ndarray,
    num_azimuth: int = 2048,
    range_bin_factor: float = 0.5,
    max_range: Optional[float] = None,
):
    """The polar slope-scatter inputs, exposed so the pipeline can run
    this scatter inside the rasterizer. Returns (ids in [0, A*R] with A*R
    the dump slot, values, table_size A*R+1)."""
    A, R, dr = polar_dims(geom, num_azimuth, range_bin_factor, max_range)
    dxy = xyz[:, :2] - sensor_origin[:2]
    dz = xyz[:, 2] - sensor_origin[2]
    len2d = jnp.linalg.norm(dxy, axis=1)
    # Skip upward rays (:173) and degenerate 2D rays (:53).
    valid = ray_mask & (dz < 0.0) & (len2d >= 1e-4)

    azim = jnp.arctan2(dxy[:, 1], dxy[:, 0])  # [-pi, pi]
    abin = jnp.clip(
        jnp.floor((azim + jnp.pi) / (2 * jnp.pi) * A).astype(jnp.int32), 0, A - 1
    )
    slope = dz / jnp.maximum(len2d, 1e-12)
    t_exit = _clip_exit(geom, position, sensor_origin, xyz)
    d_exit = t_exit * len2d
    # Round (not floor): evaluating the slope field at r*dr then lands
    # within half a bin of the true exit, halving the |slope|*dr endpoint
    # quantization error of the DDA's exit-height record.
    rbin_exit = jnp.clip(jnp.round(d_exit / dr).astype(jnp.int32), 0, R - 1)
    # [R, A] layout (range-major): the reverse cummin runs along the major
    # axis and the azimuth smears along the contiguous minor axis.
    key = jnp.where(valid, rbin_exit * A + abin, A * R)
    return key, jnp.where(valid, slope, _INF), A * R + 1


def ray_min_height_polar(
    geom: GridGeometry,
    position: jnp.ndarray,
    xyz: jnp.ndarray,
    ray_mask: jnp.ndarray,
    sensor_origin: jnp.ndarray,
    num_azimuth: int = 2048,
    range_bin_factor: float = 0.5,
    max_range: Optional[float] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-cell minimum ray height. Returns (min_height [H,W], touched)."""
    key, vals, size = polar_scatter_spec(
        geom, position, xyz, ray_mask, sensor_origin, num_azimuth,
        range_bin_factor, max_range,
    )
    table = jnp.full(size, _INF, dtype=jnp.float32).at[key].min(vals)
    return polar_resample(
        geom, position, sensor_origin, table[: size - 1], num_azimuth,
        range_bin_factor, max_range,
    )


def polar_resample(
    geom: GridGeometry,
    position: jnp.ndarray,
    sensor_origin: jnp.ndarray,
    scat_flat: jnp.ndarray,
    num_azimuth: int = 2048,
    range_bin_factor: float = 0.5,
    max_range: Optional[float] = None,
    exact_window: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Continue from the scattered [R*A] min slopes to per-cell heights.

    ``exact_window=True`` folds the window residual into the field
    (polar_smeared_field) so ONE lookup per cell replaces the two-gather
    sparse-table form — same minimum set, bitwise-identical heights.
    """
    smeared = polar_smeared_field(
        geom, sensor_origin, scat_flat, num_azimuth, range_bin_factor,
        max_range, exact_window=exact_window,
    )
    a0, a1, r_idx, in_range = resample_indices(
        geom, position, sensor_origin, num_azimuth, range_bin_factor,
        max_range,
    )
    h_cell = smeared[r_idx, a0]
    if not exact_window:
        h_cell = jnp.minimum(h_cell, smeared[r_idx, a1])
    touched = jnp.isfinite(h_cell) & in_range
    return jnp.where(touched, h_cell, jnp.nan), touched


def polar_smeared_field(
    geom: GridGeometry,
    sensor_origin: jnp.ndarray,
    scat_flat: jnp.ndarray,
    num_azimuth: int = 2048,
    range_bin_factor: float = 0.5,
    max_range: Optional[float] = None,
    exact_window: bool = False,
) -> jnp.ndarray:
    """Scattered [R*A] min slopes -> azimuth-smeared height field [R, A].

    About 30 dense passes (reverse cummin, in-cell range fold, masked
    azimuth roll-mins) that XLA fuses; the [R, A] field is a few MB."""
    A, R, dr = polar_dims(geom, num_azimuth, range_bin_factor, max_range)
    scat = scat_flat.reshape(R, A)
    ms = jax.lax.cummin(scat, axis=0, reverse=True)
    d_r = jnp.arange(R, dtype=jnp.float32)[:, None] * dr
    h_polar = jnp.where(
        jnp.isfinite(ms), sensor_origin[2] + ms * d_r, _INF
    )
    # A grid cell spans ceil(res/dr) range bins; folding that windowed min
    # into the field here (dense, free) lets the per-cell lookup use a
    # single range gather while still seeing rays that die anywhere inside
    # the cell — matching the DDA's min-over-in-cell-heights semantics.
    # (Was hardcoded to 2 bins, silently losing in-cell coverage for
    # range_bin_factor < 0.5.)
    nfold = max(1, int(math.ceil(1.0 / range_bin_factor)))

    def _shift_down(a, k):
        return jnp.concatenate([a[:1].repeat(k, axis=0), a[:-k], ], axis=0) \
            if k > 0 else a

    p = 1
    acc = h_polar
    while 2 * p <= nfold:
        acc = jnp.minimum(acc, _shift_down(acc, p))
        p *= 2
    if nfold - p > 0:
        acc = jnp.minimum(acc, _shift_down(acc, nfold - p))
    h_polar = acc

    # Azimuth-smear the field with per-range-column windows.
    # A cell at distance d spans an azimuth window w(d) that depends (for a
    # fixed geometry) only on the range bin, so the smear level per column
    # is STATIC: each column is smeared to the power-of-two window
    # p = 2^floor(log2(w)) by doubling circular roll-mins with static
    # column masks; the exact window-w minimum then comes from the classic
    # sparse-table trick — two overlapping half-window gathers — without
    # materializing an [L, A, R] table. ~9 dense masked passes + 2 gathers
    # per cell.
    lvl_static, shift_static = _column_windows(geom, A, R, dr)
    smeared = h_polar
    for k in range(int(np.max(lvl_static))):
        rowmask = jnp.asarray(lvl_static > k, dtype=bool)[:, None]
        shifted = jnp.roll(smeared, -(1 << k), axis=1)
        smeared = jnp.where(rowmask, jnp.minimum(smeared, shifted), smeared)
    if exact_window:
        # Fold the sparse-table second lookup into the field: accumulate
        # masked roll-mins at each set bit of s = w - p. After the bit-b
        # pass, entry a covers the union of p-windows at every offset that
        # is a subset-sum of s's processed bits; consecutive achievable
        # offsets differ by at most the largest bit of s < p, so the
        # p-windows overlap and the union is the CONTIGUOUS range
        # [a, a + s + p - 1] = the exact w-bin window. One gather per cell
        # then suffices (resample_indices(exact_window=True)), trading
        # ~log2(max s) dense passes for half the gather elements. Bitwise identical to the two-gather form (same min
        # set).
        max_shift = int(np.max(shift_static))
        for b in range(max(0, max_shift).bit_length()):
            rowmask = jnp.asarray(
                (shift_static >> b) & 1 == 1, dtype=bool
            )[:, None]
            shifted = jnp.roll(smeared, -(1 << b), axis=1)
            smeared = jnp.where(
                rowmask, jnp.minimum(smeared, shifted), smeared
            )
    return smeared


def resample_indices(
    geom: GridGeometry,
    position: jnp.ndarray,
    sensor_origin: jnp.ndarray,
    num_azimuth: int = 2048,
    range_bin_factor: float = 0.5,
    max_range: Optional[float] = None,
    window: Optional[Tuple] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-cell (a0, a1, r_idx, in_range) lookups into the smeared field —
    exposed so the pipeline can fuse these two gathers with the
    rasterizer's min-z-per-point gather into one call. Cells beyond the
    field's range bound report in_range=False (no ray coverage).

    ``window``: optional (r0, c0, wr, wc) — restrict the resample to the
    wr x wc cell window whose top-left cell is (r0, c0) (traced values,
    static extents). The per-cell gather is THE map-size-scaling cost of
    raycasting (one or two lookups per cell), so large global maps
    resample only a sensor-centered window of ~2*max_range extent.
    """
    A, R, dr = polar_dims(geom, num_azimuth, range_bin_factor, max_range)
    # Cartesian resample at cell centers: one gather per cell.
    if window is not None:
        r0, c0, wr, wc = window
        ox, oy = geom.origin(position)
        rr = r0 + jnp.arange(wr, dtype=jnp.int32)
        cc = c0 + jnp.arange(wc, dtype=jnp.int32)
        cx = jnp.broadcast_to(
            (ox - (rr.astype(jnp.float32) + 0.5) * geom.resolution)[:, None],
            (wr, wc),
        )
        cy = jnp.broadcast_to(
            (oy - (cc.astype(jnp.float32) + 0.5) * geom.resolution)[None, :],
            (wr, wc),
        )
    else:
        cx, cy = geom.cell_centers(position)
    ddx = cx - sensor_origin[0]
    ddy = cy - sensor_origin[1]
    dist = jnp.hypot(ddx, ddy)
    cell_az = jnp.arctan2(ddy, ddx)
    # Far-edge range (downward rays: the in-cell minimum sits at the far
    # side, matching the exit-height record of the DDA).
    r_idx = jnp.clip(
        ((dist + geom.resolution * 0.5) / dr).astype(jnp.int32), 0, R - 1
    )
    # Per-cell window/level: the SAME formulas as the static column
    # tables, evaluated elementwise (no gather needed to recover them).
    d_cell = r_idx.astype(jnp.float32) * dr
    half_w = jnp.arctan2(
        geom.resolution * AZ_HALF_WIDTH, jnp.maximum(d_cell, 1e-6)
    )
    w_bins = jnp.clip(
        jnp.ceil(half_w / (2 * jnp.pi / A) * 2.0).astype(jnp.int32) + 1,
        1,
        A // 2,
    )
    lvl_cell = jnp.floor(
        jnp.log2(jnp.maximum(w_bins, 1).astype(jnp.float32))
    ).astype(jnp.int32)
    w_pow = jnp.left_shift(jnp.int32(1), lvl_cell)
    a_center = jnp.clip(
        jnp.floor((cell_az + jnp.pi) / (2 * jnp.pi) * A).astype(jnp.int32),
        0,
        A - 1,
    )
    a0 = jnp.mod(a_center - w_bins // 2, A)
    a1 = jnp.mod(a0 + w_bins - w_pow, A)
    in_range = (dist + geom.resolution * 0.5) <= (R - 1) * dr
    return a0, a1, r_idx, in_range


def _column_windows(
    geom: GridGeometry, A: int, R: int, dr: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Static per-range-column azimuth windows: (level, shift) with
    level = floor(log2(w)) and shift = w - 2^level (the sparse-table
    residual; see polar_smeared_field's exact_window fold)."""
    d = np.arange(R, dtype=np.float32) * dr
    half_w = np.arctan2(
        geom.resolution * AZ_HALF_WIDTH, np.maximum(d, 1e-6)
    )
    w = np.clip(
        np.ceil(half_w / (2 * np.pi / A) * 2.0).astype(np.int32) + 1,
        1, A // 2,
    )
    lvl = np.floor(np.log2(np.maximum(w, 1))).astype(np.int32)
    return lvl, (w - (1 << lvl)).astype(np.int32)


def ray_min_height_sampled(
    geom: GridGeometry,
    position: jnp.ndarray,
    xyz: jnp.ndarray,
    ray_mask: jnp.ndarray,
    sensor_origin: jnp.ndarray,
    num_samples: Optional[int] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sampling + scatter-min formulation (parity oracle; ~2*(rows+cols)
    scatter elements per ray)."""
    S = num_samples or 2 * (geom.rows + geom.cols)
    ncell = geom.num_cells
    shape = geom.shape
    dz = xyz[:, 2] - sensor_origin[2]
    dxy = xyz[:, :2] - sensor_origin[:2]
    ray_len_2d = jnp.linalg.norm(dxy, axis=1)
    ray_valid = ray_mask & (dz < 0.0) & (ray_len_2d >= 1e-4)

    t_exit = _clip_exit(geom, position, sensor_origin, xyz)
    frac = (jnp.arange(S, dtype=jnp.float32) + 1.0) / S
    t = t_exit[:, None] * frac[None, :]
    sx = sensor_origin[0] + t * (xyz[:, 0] - sensor_origin[0])[:, None]
    sy = sensor_origin[1] + t * (xyz[:, 1] - sensor_origin[1])[:, None]
    sh = sensor_origin[2] + t * dz[:, None]
    samp_xy = jnp.stack([sx, sy], axis=-1)
    sids, s_inside = geom.cell_id_of(position, samp_xy)
    s_valid = ray_valid[:, None] & s_inside
    sids = jnp.where(s_valid, sids, ncell)
    ray_min = (
        jnp.full(ncell + 1, _INF, dtype=jnp.float32)
        .at[sids.reshape(-1)]
        .min(jnp.where(s_valid, sh, _INF).reshape(-1))[:ncell]
    ).reshape(shape)
    touched = jnp.isfinite(ray_min)
    return jnp.where(touched, ray_min, jnp.nan), touched


def apply_raycasting(
    geom: GridGeometry,
    state: GridMapState,
    xyz: jnp.ndarray,
    scan_mask: jnp.ndarray,
    sensor_origin: jnp.ndarray,
    cfg: RaycastingConfig,
    obs_count: Optional[jnp.ndarray] = None,
    method: str = "polar",
    num_samples: Optional[int] = None,
    num_azimuth: int = 2048,
    range_bin_factor: float = 0.5,
    max_range: Optional[float] = None,
    polar_table: Optional[jnp.ndarray] = None,
    ray_min_touched: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
    frame_nonempty=True,
) -> GridMapState:
    """Apply one scan's visibility update.

    ``obs_count``: per-cell observed-point multiplicity (distinct z-voxels)
    from the rasterizer; computed here via a scatter when absent
    (standalone use). ``xyz``/``scan_mask`` is the scan in the world frame;
    when obs_count is None, the mask should already be voxel-downsampled.
    Both may be None when ``obs_count`` AND ``ray_min_touched`` are
    provided (the fused pipeline passes only the precomputed dense fields).
    ``polar_table``: pre-scattered [A*R] min-slope table (the pipeline
    fuses that scatter with the rasterizer's — see polar_scatter_spec).
    """
    ncell = geom.num_cells
    shape = geom.shape

    origin_inside = geom.is_inside(state.position, sensor_origin[:2])
    active = None if scan_mask is None else scan_mask & origin_inside

    # ---- 1. Observed evidence (add-then-clamp, :165-169) ----
    if obs_count is None:
        ids, inside = geom.cell_id_of(state.position, xyz[:, :2])
        obs_valid = active & inside
        ids_obs = jnp.where(obs_valid, ids, ncell)
        obs_count_eff = (
            jnp.zeros(ncell + 1, dtype=jnp.float32)
            .at[ids_obs]
            .add(obs_valid.astype(jnp.float32))[:ncell]
        ).reshape(shape)
    else:
        obs_count_eff = jnp.where(origin_inside, obs_count, 0.0)
    add = obs_count_eff * cfg.log_odds_observed
    lo = state.layers[layers.visibility_logodds]
    lo_base = jnp.where(jnp.isnan(lo), 0.0, lo)
    lo1 = jnp.where(
        add > 0.0, jnp.minimum(lo_base + add, cfg.log_odds_max), lo
    )

    # ---- 2. Per-cell min ray height ----
    if ray_min_touched is not None:
        ray_min, ray_touched = ray_min_touched
    elif method == "polar" and polar_table is not None:
        ray_min, ray_touched = polar_resample(
            geom, state.position, sensor_origin, polar_table,
            num_azimuth=num_azimuth, range_bin_factor=range_bin_factor,
            max_range=max_range,
        )
    elif method == "polar":
        ray_min, ray_touched = ray_min_height_polar(
            geom, state.position, xyz, active, sensor_origin,
            num_azimuth=num_azimuth, range_bin_factor=range_bin_factor,
            max_range=max_range,
        )
    else:
        ray_min, ray_touched = ray_min_height_sampled(
            geom, state.position, xyz, active, sensor_origin,
            num_samples=num_samples,
        )
    # Per-scan overwrite of the diagnostic layer; an all-masked frame
    # keeps the previous one (the reference never integrates empty scans —
    # this makes batch-replay padding frames full no-ops, like the
    # obstacle layer's gate in pipeline._update_obstacle).
    ray_layer = jnp.where(
        frame_nonempty,
        jnp.where(ray_touched, ray_min, jnp.nan),
        state.layers[layers.raycasting],
    )
    ray_min_cmp = jnp.where(ray_touched, ray_min, _INF)

    # ---- 3. Resolve ghost cells (:188-214) ----
    elev = state.layers[layers.elevation]
    conflict = (
        ray_touched
        & jnp.isfinite(elev)
        & (elev > ray_min_cmp + cfg.height_conflict_threshold)
    )
    lo2 = jnp.where(
        conflict, jnp.where(jnp.isnan(lo1), 0.0, lo1) - cfg.log_odds_ghost, lo1
    )
    clear = conflict & (lo2 < cfg.clear_threshold)

    state = state.replace_layers(
        {layers.visibility_logodds: lo2, layers.raycasting: ray_layer}
    )
    cleared = {
        k: jnp.where(clear, jnp.nan, v) for k, v in state.layers.items()
    }
    cleared[layers.ghost_removal] = jnp.where(
        clear, 1.0, state.layers[layers.ghost_removal]
    )
    return GridMapState(layers=cleared, position=state.position)
