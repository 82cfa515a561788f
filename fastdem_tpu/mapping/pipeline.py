"""The FastDEM pipeline: preprocess -> map update -> estimate -> raycast.

Functional, jit-compiled equivalent of the reference facade + mapper:
  * FastDEM::integrateImpl / preprocessScan
    (/root/reference/fastdem/src/fastdem.cpp:133-190)
  * ElevationMapping::update / rasterize / estimate / updateMinMax /
    updateObstacle / updateIntensity / updateColor
    (/root/reference/fastdem/src/elevation_mapping.cpp:41-175)

``build_integrate(geom, cfg, ...)`` returns one jitted step function
  (state, xyz, mask, T_base_sensor, T_world_base[, intensity, color])
    -> (state, IntegrateAux)
with the map state donated, so each scan is a single device dispatch that
updates the HBM-resident map in place.

Hot-path fusions vs. the reference (numerics preserved):
  * Sensor covariance is never materialized as [N, 3, 3]: only the world
    z-variance r3^T Sigma r3 is computed (see sensors/models.py docstring).
  * Crop filters are mask intersections, not compactions.
  * Rasterize is scatter-min/max; estimators are dense masked passes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from fastdem_tpu.cloud import pointcloud as pc
from fastdem_tpu.cloud import transform as tfm
from fastdem_tpu.config.config import (
    Config,
    EstimationType,
    MappingMode,
)
from fastdem_tpu.grid import gridmap
from fastdem_tpu.grid.geometry import GridGeometry
from fastdem_tpu.grid.gridmap import GridMapState, layers
from fastdem_tpu.mapping import kalman as kalman_est
from fastdem_tpu.mapping import p2 as p2_est
from fastdem_tpu.mapping import rasterize as raster
from fastdem_tpu.postprocess import raycasting as raycast
from fastdem_tpu.sensors.models import create_sensor_model


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class IntegrateAux:
    """Per-scan auxiliary outputs (feeds the reference's observation
    callbacks, fastdem.hpp:124-128: onScanPreprocessed / onScanRasterized)."""

    world_xyz: jnp.ndarray  # preprocessed points in the map frame
    world_mask: jnp.ndarray  # surviving-point mask after filters
    z_var: jnp.ndarray  # world z-variance per point
    obs: raster.CellObservations  # rasterized per-cell observations
    # Surviving in-map points the update window missed (None when the
    # windowed-update path is off). Nonzero means the base->sensor offset
    # exceeded the built window margin and points were DROPPED — the
    # facade widens the margin / the driver warns.
    oow_points: Optional[jnp.ndarray] = None


def estimator_layer_fills(cfg: Config) -> Dict[str, float]:
    if cfg.mapping.estimation_type == EstimationType.P2_QUANTILE:
        return p2_est.layer_fills()
    return kalman_est.layer_fills()


def initial_layer_fills(
    cfg: Config, has_intensity: bool = False, has_color: bool = False
) -> Dict[str, float]:
    """Full static layer set for a pipeline run (ElevationMapping ctor,
    src/elevation_mapping.cpp:11-39, plus lazily-created layers which are
    static here because jit requires a fixed pytree structure)."""
    fills = gridmap.default_layer_fills()
    fills.update(estimator_layer_fills(cfg))
    fills[layers.obstacle] = np.nan
    if has_intensity:
        fills[layers.intensity] = np.nan
    if has_color:
        fills[layers.color] = np.nan
    if cfg.raycasting.enabled:
        fills.update(raycast.layer_fills())
    return fills


def create_map_state(
    geom: GridGeometry,
    cfg: Config,
    position=(0.0, 0.0),
    has_intensity: bool = False,
    has_color: bool = False,
) -> GridMapState:
    return gridmap.create(
        geom, initial_layer_fills(cfg, has_intensity, has_color), position
    )


def _estimate(state: GridMapState, cfg: Config, obs: raster.CellObservations):
    """estimator.update + computeBounds per touched cell
    (src/elevation_mapping.cpp:94-108)."""
    if cfg.mapping.estimation_type == EstimationType.P2_QUANTILE:
        return p2_est.estimate(
            state, cfg.mapping.p2, obs.min_z, obs.min_z_var, obs.touched
        )
    return kalman_est.update(
        state, cfg.mapping.kalman, obs.min_z, obs.min_z_var, obs.touched
    )


def _update_minmax(state: GridMapState, obs: raster.CellObservations):
    """Accumulating min/max layers (src/elevation_mapping.cpp:127-142)."""
    stored_min = state.layers[layers.elevation_min]
    stored_max = state.layers[layers.elevation_max]
    new_min = jnp.where(
        obs.touched & (jnp.isnan(stored_min) | (obs.min_z < stored_min)),
        obs.min_z,
        stored_min,
    )
    new_max = jnp.where(
        obs.touched & (jnp.isnan(stored_max) | (obs.max_z > stored_max)),
        obs.max_z,
        stored_max,
    )
    return state.replace_layers(
        {layers.elevation_min: new_min, layers.elevation_max: new_max}
    )


def _update_obstacle(
    state: GridMapState, obs: raster.CellObservations, frame_nonempty
):
    """Per-frame overwrite: obstacle = max_z iff max_z > min_z else NaN
    (src/elevation_mapping.cpp:144-152; the layer is cleared first).

    ``frame_nonempty`` (any input point valid BEFORE filtering) gates the
    overwrite: the reference rejects empty clouds before integrateImpl
    (src/fastdem.cpp:122-131), so an all-masked frame must be a full no-op
    — this makes batch-replay padding frames provably inert
    (build_integrate_sequence). A nonempty scan still clears the layer even
    if every point is filtered/out-of-map, like the reference."""
    obstacle = jnp.where(
        obs.touched & (obs.max_z > obs.min_z), obs.max_z, jnp.nan
    )
    obstacle = jnp.where(
        frame_nonempty, obstacle, state.layers[layers.obstacle]
    )
    return state.replace_layer(layers.obstacle, obstacle)


def _update_intensity(state: GridMapState, obs: raster.CellObservations):
    """Max-pool accumulation (src/elevation_mapping.cpp:154-166)."""
    if obs.max_intensity is None or layers.intensity not in state.layers:
        return state
    stored = state.layers[layers.intensity]
    has_obs = ~jnp.isnan(obs.max_intensity)
    new = jnp.where(
        has_obs & (jnp.isnan(stored) | (obs.max_intensity > stored)),
        obs.max_intensity,
        stored,
    )
    return state.replace_layer(layers.intensity, new)


def _update_color(state: GridMapState, obs: raster.CellObservations):
    """Write-through color (src/elevation_mapping.cpp:168-175; reference is
    last-write, here the min-z point's color — see rasterize.py)."""
    if obs.color is None or layers.color not in state.layers:
        return state
    stored = state.layers[layers.color]
    has_obs = ~jnp.isnan(obs.color)
    return state.replace_layer(
        layers.color, jnp.where(has_obs, obs.color, stored)
    )


def _expand_obs(
    geom: GridGeometry, obs: raster.CellObservations, win_rc
) -> raster.CellObservations:
    """Expand window-shaped CellObservations to the full map (NaN / False /
    0 outside the window) for the aux-callback surface."""
    r0, c0 = win_rc[0], win_rc[1]

    def put(f, fill, dtype=None):
        if f is None:
            return None
        full = jnp.full(geom.shape, fill, dtype=dtype or f.dtype)
        return jax.lax.dynamic_update_slice(full, f, (r0, c0))

    return raster.CellObservations(
        min_z=put(obs.min_z, jnp.nan),
        min_z_var=put(obs.min_z_var, jnp.nan),
        max_z=put(obs.max_z, jnp.nan),
        touched=put(obs.touched, False),
        max_intensity=put(obs.max_intensity, jnp.nan),
        color=put(obs.color, jnp.nan),
        voxel_count=put(obs.voxel_count, 0.0),
        extra=obs.extra,
    )


def build_integrate(
    geom: GridGeometry,
    cfg: Config,
    has_intensity: bool = False,
    has_color: bool = False,
    jit: bool = True,
    donate: bool = True,
    ray_num_azimuth: Optional[int] = None,
    ray_range_bin_factor: Optional[float] = None,
    ray_max_range: Optional[float] = None,
    ray_exact_window: bool = True,
    scatter_mode: str = "rows",
    voxel_count_mode: Optional[str] = None,
    window_update: Optional[bool] = None,
    window_margin: float = 2.0,
    spmd_blocks: Optional[tuple] = None,
):
    """Compile the per-scan integrate step.

    Returned signature:
      integrate(state, xyz, mask, T_base_sensor, T_world_base,
                intensity=None, color_packed=None) -> (state, IntegrateAux)

    ``xyz`` is the sensor-frame cloud (f32[N, 3]); transforms are 4x4 f32.

    ``scatter_mode``: "rows" (default — row-widened single-index scatter,
    rasterize.rasterize_scatter_rows; per-INDEX cost model, r2), "packed"
    (round-1 flat argmin-carry scatter) or "twophase" (two-phase f32
    scatter; exact reference tie semantics for sub-quantum z ties).
    ``voxel_count_mode``: "exact" or "span" — the raycaster's observed-
    evidence multiplicity (rasterize_scatter_packed docstring); "span"
    requires scatter_mode="packed". Defaults to
    ``cfg.raycasting.voxel_count_mode``.

    ``spmd_blocks``: (mx, my) mesh extents — build the step for execution
    INSIDE ``shard_map`` over a ("mx", "my") device mesh with the layer
    arrays block-sharded [rows/mx, cols/my] and every other input
    replicated. Each device runs the windowed update on the (statically
    clamped) intersection of the global update window with its block, so
    no collective appears anywhere in the step — the polar ray field is
    computed per-device from the replicated points. Requires GLOBAL
    mode and a configuration where the windowed path engages. The
    returned aux carries ``obs=None`` (window-shaped observations cannot
    be expanded device-locally to the full map).
    """
    phase_a, phase_b, moved_position, _ = _build_phases(
        geom, cfg, ray_num_azimuth, ray_range_bin_factor, ray_max_range,
        scatter_mode, voxel_count_mode, ray_exact_window,
        window_update=window_update,
        window_margin=window_margin, spmd_blocks=spmd_blocks,
    )
    local_mode = cfg.mapping.mode == MappingMode.LOCAL

    def integrate(state, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None):
        # The map position AFTER the LOCAL move is pure pose arithmetic
        # (a lattice walk), so the whole per-scan phase A — preprocess,
        # rasterize, ray-field realization — depends only on the inputs,
        # not on the carried layers (this is what lets
        # build_integrate_fused batch phase A across scans).
        position = (
            moved_position(state.position, T_wb[:2, 3])
            if local_mode
            else state.position
        )
        pa = phase_a(position, xyz, mask, T_bs, T_wb, intensity, color_packed)
        state = phase_b(state, T_wb, jnp.any(mask), pa)
        obs, _ray, _origin, xyz_world, keep, z_var, win_rc, oow = pa
        if spmd_blocks is not None:
            # Per-device window-shaped observations; no device-local
            # full-map expansion exists (see docstring).
            obs = None
        elif win_rc is not None:
            # Windowed update: the aux callbacks see full-map observations
            # (expanded here; DCE'd when the caller discards aux).
            obs = _expand_obs(geom, obs, win_rc)
        aux = IntegrateAux(
            world_xyz=xyz_world, world_mask=keep, z_var=z_var, obs=obs,
            oow_points=oow,
        )
        return state, aux

    if jit:
        return jax.jit(integrate, donate_argnums=(0,) if donate else ())
    return integrate


def _build_phases(
    geom: GridGeometry,
    cfg: Config,
    ray_num_azimuth: Optional[int],
    ray_range_bin_factor: Optional[float],
    ray_max_range: Optional[float],
    scatter_mode: str,
    voxel_count_mode: Optional[str],
    ray_exact_window: bool = True,
    window_update: Optional[bool] = None,
    window_margin: float = 2.0,
    spmd_blocks: Optional[tuple] = None,
):
    """Split the integrate step into:

    * ``phase_a(position, xyz, mask, T_bs, T_wb, intensity, color)`` —
      all per-scan work with no dependence on the carried map layers
      (preprocess fastdem.cpp:164-190, the fused rasterize scatter/gather,
      and the polar ray-field realization), given the post-move map
      position. vmap-able over scans.
    * ``phase_b(state, T_wb, frame_nonempty, pa)`` — the sequential map
      update (move, estimator recurrence, layer maintenance, raycast
      visibility update), all dense elementwise work.
    * ``moved_position(position, target_xy)`` — gridmap.move's position
      lattice walk (elevation_mapping.cpp:112-114), exposed so callers can
      precompute per-scan positions for phase A.
    * ``phase_a_batched(positions, xyz, mask, T_bs, T_wb, ...)`` — K-scan
      microbatched phase A: dense prep is vmapped, the irregular ops are
      single flat offset-index ops (rasterize_scatter_rows_batched). None
      when the configuration can't use it (non-"rows" scatter path or the
      sampled raycast method).
    """
    if voxel_count_mode is None:
        voxel_count_mode = cfg.raycasting.voxel_count_mode
    # Polar-field resolution comes from the config unless the caller
    # overrides (raycasting.num_azimuth_bins / range_bin_factor —
    # extension keys, see config.py).
    if ray_num_azimuth is None:
        ray_num_azimuth = int(cfg.raycasting.num_azimuth_bins)
    if ray_range_bin_factor is None:
        ray_range_bin_factor = float(cfg.raycasting.range_bin_factor)
    # An EXPLICIT bound (caller arg or config key) is respected as-is; only
    # DERIVED bounds may later be tightened by the LOCAL half-diagonal
    # heuristic (whose 2 m base->sensor margin an operator with an unusual
    # extrinsic can overrule by setting raycasting.max_range).
    ray_range_explicit = ray_max_range is not None
    if ray_max_range is None and cfg.raycasting.max_range > 0:
        ray_max_range = float(cfg.raycasting.max_range)
        ray_range_explicit = True
    if scatter_mode not in ("rows", "packed", "twophase", "sort"):
        raise ValueError(f"unknown scatter_mode: {scatter_mode!r}")
    if voxel_count_mode == "span" and scatter_mode == "twophase":
        raise ValueError('voxel_count_mode="span" needs rows/packed mode')
    if scatter_mode == "sort" and cfg.raycasting.enabled:
        # The sort-based rasterizer has no fused-scatter/gather riders for
        # the polar ray field (it exists as the RGB-D-scale A/B).
        raise ValueError('scatter_mode="sort" requires raycasting disabled')
    if scatter_mode == "sort":
        def raster_fn(geom_, position_, xyz_, mask_, zv_, intensity=None,
                      color_packed=None, with_voxel_count=False,
                      extra_min_scatter=None, phase_gather_rider=None):
            assert extra_min_scatter is None and phase_gather_rider is None
            return raster.rasterize(
                geom_, position_, xyz_, mask_, zv_, intensity=intensity,
                color_packed=color_packed,
                with_voxel_count=with_voxel_count,
            )
    else:
        raster_fn = raster.rasterize_scatter
    sensor = create_sensor_model(cfg.sensor_model)
    pf = cfg.point_filter
    local_mode = cfg.mapping.mode == MappingMode.LOCAL
    # Squared range bounds precomputed in Python, clamped to the f32 range
    # (range_max defaults to FLT_MAX; its square must not overflow the cast).
    _F32_MAX = 3.4028235e38
    rmin2 = min(pf.range_min * pf.range_min, _F32_MAX)
    rmax2 = min(pf.range_max * pf.range_max, _F32_MAX)
    # Polar-field range bound: surviving points lie within range_max of the
    # BASE frame; the base->sensor offset is bounded by ``window_margin``
    # (default 2 m; the facade widens it automatically when a larger static
    # extrinsic is registered), so range_max + margin bounds
    # every ray from the sensor. Without a finite range filter the field
    # spans the map diagonal (prohibitive on large global maps — set a
    # range filter or ray_max_range for those).
    window_margin = max(float(window_margin), 0.0)
    if ray_max_range is None and pf.range_max < 1e6:
        ray_max_range = float(pf.range_max) * 1.1 + window_margin
    if local_mode:
        # LOCAL maps follow the robot, so after move() the sensor sits
        # within half a cell (+ the base->sensor offset) of the map
        # center: no in-map ray can extend past the HALF diagonal plus a
        # small margin. Bounding the polar field there halves its range
        # axis vs the conservative full-diagonal default (rays whose true
        # exit lies beyond clip to the last range bin, which the reverse
        # cummin treats as alive through the whole bounded field —
        # conservative-correct for every in-range cell; cells beyond the
        # bound cannot exist when the sensor offset stays under the
        # margin). Margin: window_margin of sensor offset + 2 cells.
        half_diag = (
            0.5 * math.hypot(geom.rows, geom.cols) * geom.resolution
        )
        local_bound = half_diag + window_margin + 2.0 * geom.resolution
        if ray_max_range is None or (
            not ray_range_explicit and ray_max_range > local_bound
        ):
            ray_max_range = local_bound

    # ---- Update window: O(range^2) per-scan cost on large maps ----
    # Every cell a scan can touch lies within the POINT FILTER's range
    # bound of the sensor (points pass the filter in the BASE frame; the
    # bound carries a ``window_margin`` base->sensor allowance — same
    # analysis as the polar-field bound above; rays end AT points, so the
    # same bound covers ray-touched cells even when raycasting.max_range is
    # set smaller/larger), so BOTH the rasterizer's scatter tables and the
    # dense map update (estimator recurrence, min/max/obstacle, raycast
    # log-odds) can run on a window of ~2*bound extent dynamic-sliced
    # around the sensor and written back with one dynamic_update_slice per
    # layer. On a 200 m global map this turns ~25 full 4M-cell layer
    # passes per scan into 160K-cell passes. Identical results: window
    # membership only re-bases scatter ids, and every touched cell is in
    # the window by the bound. Enabled when the window is at most half the
    # map (else the slice/write-back overhead buys nothing).
    #
    # NOTE: the window bound derives ONLY from the point filter, never
    # from raycasting.max_range — that key bounds the polar ray FIELD
    # (conservative) and must not gate which points rasterize.
    upd_bound = (
        float(pf.range_max) * 1.1 + window_margin
        if pf.range_max < 1e6
        else None
    )
    if upd_bound is not None:
        _wcells = int(math.ceil(2.0 * upd_bound / geom.resolution)) + 4
        upd_wr, upd_wc = min(geom.rows, _wcells), min(geom.cols, _wcells)
    else:
        upd_wr, upd_wc = geom.rows, geom.cols
    windowed = (
        window_update is not False
        and scatter_mode in ("rows", "packed")
        and 2 * upd_wr * upd_wc <= geom.num_cells
        and not (cfg.raycasting.enabled and cfg.raycasting.method == "sampled")
    )
    # shard_map execution (see build_integrate docstring): the GLOBAL
    # window is clamped per device onto its block; a window of size
    # min(global window, block) positioned at clip(g0 - block0, 0,
    # block - w') always covers window-intersect-block, and blocks are
    # disjoint, so the per-device updates tile the global windowed update
    # exactly. Points are additionally masked to the GLOBAL window so a
    # block-edge-clamped device window never rasterizes points the
    # unsharded windowed path would not.
    upd_wr_g, upd_wc_g = upd_wr, upd_wc
    if spmd_blocks is not None:
        smx, smy = int(spmd_blocks[0]), int(spmd_blocks[1])
        if local_mode:
            raise ValueError("spmd_blocks requires GLOBAL mapping mode")
        if not windowed:
            raise ValueError(
                "spmd_blocks requires a configuration where the windowed "
                "update engages (finite point_filter.range_max with a "
                "window at most half the map; rows/packed scatter mode)"
            )
        if geom.rows % smx or geom.cols % smy:
            raise ValueError(
                f"map shape {geom.shape} not divisible by mesh {spmd_blocks}"
            )
        block_rows, block_cols = geom.rows // smx, geom.cols // smy
        upd_wr = min(upd_wr_g, block_rows)
        upd_wc = min(upd_wc_g, block_cols)
    eff_cells = upd_wr * upd_wc if windowed else geom.num_cells
    if scatter_mode == "rows" and eff_cells > (1 << 19):
        # On the GPU the row table is (cells+1) x L x 4 B with no
        # padding, re-initialized every scan (the 32 voxel-presence lanes
        # drop out above 2^23 table entries). Which formulation is faster
        # on the largest maps is not measured yet (ROADMAP item 3); this
        # size keeps the flat packed formulation, whose tables scale with
        # the lanes actually used. (Windowed maps size the table by the
        # window, so rows mode usually survives.)
        scatter_mode = "packed"
    if scatter_mode in ("rows", "packed"):
        import functools

        raster_fn = functools.partial(
            raster.rasterize_scatter_rows
            if scatter_mode == "rows"
            else raster.rasterize_scatter_packed,
            voxel_count_mode=voxel_count_mode,
        )

    def moved_position(position, target_xy):
        # Must match gridmap.move's arithmetic exactly (grid/gridmap.py).
        res = geom.resolution
        delta = gridmap.round_half_away(
            (target_xy - position) / res
        ).astype(jnp.int32)
        return position + delta.astype(jnp.float32) * res

    def phase_a(position, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None):
        # ---- 1. Preprocess (fastdem.cpp:164-190) ----
        T_ws = jnp.matmul(T_wb, T_bs, precision=tfm.HIGHEST)
        r3 = T_ws[2, :3]  # third row of the sensor->world rotation
        z_var = sensor.z_variance_world(xyz, r3)

        xyz_base = tfm.transform_points(xyz, T_bs)
        d2 = jnp.sum(xyz_base * xyz_base, axis=-1)
        keep = (
            mask
            & (d2 >= rmin2)
            & (d2 <= rmax2)
            & (xyz_base[:, 2] >= pf.z_min)
            & (xyz_base[:, 2] <= pf.z_max)
        )
        xyz_world = tfm.transform_points(xyz_base, T_wb)

        # When raycasting is on, the polar slope scatter spec is handed to
        # the rasterizer (rows mode runs it as its own flat scatter;
        # packed/twophase fuse it into their widened tables).
        extra = None
        rider = None
        ray_window = None
        sensor_origin = T_ws[:3, 3]
        ray_sampled = None

        # Sensor-centered update window (see the build-time block above).
        upd_window = None
        oow_points = None
        keep_r = keep  # rasterizer mask (tightened to the global window
        # under shard_map; the window itself masks it otherwise)
        quant_mask = None
        win_store = None  # offsets phase_b slices at (local under spmd)
        if windowed:
            sr, sc, _ = geom.index_of(position, sensor_origin[:2])
            ur0 = jnp.clip(
                jnp.clip(sr, 0, geom.rows) - upd_wr_g // 2,
                0, geom.rows - upd_wr_g,
            )
            uc0 = jnp.clip(
                jnp.clip(sc, 0, geom.cols) - upd_wc_g // 2,
                0, geom.cols - upd_wc_g,
            )
            # Window-violation guard: the bound above
            # assumes the base->sensor translation stays under
            # window_margin. Count surviving IN-MAP points the GLOBAL
            # window misses — such points would be silently dropped — so
            # the facade/driver can warn (and the facade widen the margin)
            # instead. One dense pass over N points; rides phase A.
            pr, pc, in_map = geom.index_of(position, xyz_world[:, :2])
            in_gwin = (
                (pr >= ur0)
                & (pr < ur0 + upd_wr_g)
                & (pc >= uc0)
                & (pc < uc0 + upd_wc_g)
            )
            oow = keep & in_map & ~in_gwin
            oow_points = jnp.sum(oow).astype(jnp.int32)
            if spmd_blocks is None:
                upd_window = (ur0, uc0, upd_wr, upd_wc)
                win_store = (ur0, uc0)
            else:
                # Per-device window: the global window clamped onto this
                # device's block (covers window-intersect-block exactly;
                # see the build-time note).
                br0 = jax.lax.axis_index("mx").astype(jnp.int32) * block_rows
                bc0 = jax.lax.axis_index("my").astype(jnp.int32) * block_cols
                lur0 = jnp.clip(ur0 - br0, 0, block_rows - upd_wr)
                luc0 = jnp.clip(uc0 - bc0, 0, block_cols - upd_wc)
                upd_window = (br0 + lur0, bc0 + luc0, upd_wr, upd_wc)
                win_store = (lur0, luc0)
                keep_r = keep & in_gwin
                # The one-device path quantizes argmin z over every point
                # of the global window; so does each device.
                quant_mask = keep & in_map & in_gwin
        if cfg.raycasting.enabled and cfg.raycasting.method == "sampled":
            # Exactness-first mode: per-ray segment sampling at
            # dt <= res/sqrt(2) — every traversed cell is sampled like
            # the reference DDA. Two orders of magnitude more scatter
            # elements than the polar path; offline use
            # (raycasting.method config key).
            origin_inside = geom.is_inside(position, sensor_origin[:2])
            ray_sampled = raycast.ray_min_height_sampled(
                geom, position, xyz_world, keep & origin_inside,
                sensor_origin,
            )
        elif cfg.raycasting.enabled:
            origin_inside = geom.is_inside(position, sensor_origin[:2])
            extra = raycast.polar_scatter_spec(
                geom, position, xyz_world, keep & origin_inside,
                sensor_origin, ray_num_azimuth, ray_range_bin_factor,
                ray_max_range,
            )

            # The per-cell field lookups are the map-size-scaling cost of
            # raycasting; on maps larger than the ray range, resample only
            # a sensor-centered window (rays cannot reach farther). With
            # the update window active, the resample uses the SAME window
            # (same bound, same formula).
            if upd_window is not None:
                ray_window = upd_window
            else:
                if ray_max_range is not None:
                    wcells = (
                        int(math.ceil(2.0 * ray_max_range / geom.resolution))
                        + 4
                    )
                    wr = min(geom.rows, wcells)
                    wc = min(geom.cols, wcells)
                else:
                    wr, wc = geom.rows, geom.cols
                if (wr, wc) != (geom.rows, geom.cols):
                    sr, sc, _ = geom.index_of(position, sensor_origin[:2])
                    r0 = jnp.clip(sr, 0, geom.rows) - wr // 2
                    r0 = jnp.clip(r0, 0, geom.rows - wr)
                    c0 = jnp.clip(sc, 0, geom.cols) - wc // 2
                    c0 = jnp.clip(c0, 0, geom.cols - wc)
                    ray_window = (r0, c0, wr, wc)

            # The raycaster's per-cell field lookups are realized inside
            # the rasterizer (phase_gather_rider) as a tile-row gather.
            # With ray_exact_window the smear already covers the exact
            # azimuth window, so ONE lookup per cell replaces the
            # two-gather sparse-table form (bitwise-identical heights,
            # half the serialized gather indices).
            a0, a1, r_idx, ray_in_range = raycast.resample_indices(
                geom, position, sensor_origin,
                ray_num_azimuth, ray_range_bin_factor, ray_max_range,
                window=ray_window,
            )
            # [R, A] field layout: flat = r * A + a.
            flat0 = (r_idx * ray_num_azimuth + a0).reshape(-1)
            if ray_exact_window:
                flat_idx = flat0
            else:
                flat1 = (r_idx * ray_num_azimuth + a1).reshape(-1)
                flat_idx = jnp.concatenate([flat0, flat1])

            def rider(polar_table):
                smeared = raycast.polar_smeared_field(
                    geom, sensor_origin, polar_table,
                    ray_num_azimuth, ray_range_bin_factor, ray_max_range,
                    exact_window=ray_exact_window,
                )
                return smeared.reshape(-1), flat_idx

        kwargs = {}
        if upd_window is not None:
            kwargs["window"] = upd_window
        if quant_mask is not None:
            kwargs["quant_mask"] = quant_mask
        obs = raster_fn(
            geom,
            position,
            xyz_world,
            keep_r,
            z_var,
            intensity=intensity,
            color_packed=color_packed,
            with_voxel_count=cfg.raycasting.enabled,
            extra_min_scatter=extra,
            phase_gather_rider=rider,
            **kwargs,
        )

        # ---- Ray-field realization (the dense tail of the polar
        # raycast; fastdem.cpp:152-159 / src/raycasting.cpp:46-139) ----
        ray = None
        if ray_sampled is not None:
            ray = ray_sampled
        elif cfg.raycasting.enabled:
            # Observed-evidence multiplicity comes from the rasterizer's
            # distinct-z-voxel counts (the reference voxel-downsamples the
            # scan first, src/fastdem.cpp:156-158); the polar reducer takes
            # all rays directly (dedup is unnecessary there — see
            # postprocess/raycasting.py docstring) and its slope table was
            # already scattered in phase 1 (obs.extra).
            if ray_window is not None:
                r0, c0, wr, wc = ray_window
                nwin = wr * wc
                if ray_exact_window:
                    h_cell_w = obs.extra[:nwin].reshape(wr, wc)
                else:
                    h_cell_w = jnp.minimum(
                        obs.extra[:nwin].reshape(wr, wc),
                        obs.extra[nwin:].reshape(wr, wc),
                    )
                touched_w = jnp.isfinite(h_cell_w) & ray_in_range
                if upd_window is not None:
                    # Windowed update: phase B consumes window-shaped
                    # fields directly — no full-map materialization.
                    ray = (
                        jnp.where(touched_w, h_cell_w, jnp.nan), touched_w
                    )
                else:
                    ray_min = jax.lax.dynamic_update_slice(
                        jnp.full(geom.shape, jnp.nan),
                        jnp.where(touched_w, h_cell_w, jnp.nan),
                        (r0, c0),
                    )
                    ray_touched = jax.lax.dynamic_update_slice(
                        jnp.zeros(geom.shape, dtype=bool), touched_w,
                        (r0, c0),
                    )
                    ray = (ray_min, ray_touched)
            else:
                ncell = geom.num_cells
                if ray_exact_window:
                    h_cell = obs.extra[:ncell].reshape(geom.shape)
                else:
                    h0 = obs.extra[:ncell].reshape(geom.shape)
                    h1 = obs.extra[ncell:].reshape(geom.shape)
                    h_cell = jnp.minimum(h0, h1)
                ray_touched = jnp.isfinite(h_cell) & ray_in_range
                ray_min = jnp.where(ray_touched, h_cell, jnp.nan)
                ray = (ray_min, ray_touched)

        win_rc = (
            jnp.stack([win_store[0], win_store[1]])
            if win_store is not None
            else None
        )
        return (
            obs, ray, sensor_origin, xyz_world, keep, z_var, win_rc,
            oow_points,
        )

    def phase_a_batched(
        positions, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None
    ):
        """K-scan phase A with flat offset-index irregular ops (see
        rasterize.rasterize_scatter_rows_batched). Per-scan semantics match
        ``phase_a``; dense prep is vmapped (FMA reassociation possible at
        polar-bin boundaries — build_integrate_sequence's ray-layer note)."""
        Kb = xyz.shape[0]
        T_bs_b = jnp.broadcast_to(T_bs, (Kb, 4, 4))
        T_ws = jnp.matmul(T_wb, T_bs_b, precision=tfm.HIGHEST)
        r3 = T_ws[:, 2, :3]
        z_var = jax.vmap(sensor.z_variance_world)(xyz, r3)

        xyz_base = jax.vmap(tfm.transform_points)(xyz, T_bs_b)
        d2 = jnp.sum(xyz_base * xyz_base, axis=-1)
        keep = (
            mask
            & (d2 >= rmin2)
            & (d2 <= rmax2)
            & (xyz_base[:, :, 2] >= pf.z_min)
            & (xyz_base[:, :, 2] <= pf.z_max)
        )
        xyz_world = jax.vmap(tfm.transform_points)(xyz_base, T_wb)

        extra = None
        rider = None
        ray_window = None
        sensor_origin = T_ws[:, :3, 3]
        if cfg.raycasting.enabled:
            origin_inside = jax.vmap(geom.is_inside)(
                positions, sensor_origin[:, :2]
            )
            ray_mask = keep & origin_inside[:, None]
            e_keys, e_vals, e_size = jax.vmap(
                lambda p, xw, m, so: raycast.polar_scatter_spec(
                    geom, p, xw, m, so, ray_num_azimuth,
                    ray_range_bin_factor, ray_max_range,
                ),
                out_axes=(0, 0, None),
            )(positions, xyz_world, ray_mask, sensor_origin)
            extra = (e_keys, e_vals, e_size)

            if ray_max_range is not None:
                wcells = (
                    int(math.ceil(2.0 * ray_max_range / geom.resolution)) + 4
                )
                wr = min(geom.rows, wcells)
                wc = min(geom.cols, wcells)
            else:
                wr, wc = geom.rows, geom.cols
            if (wr, wc) != (geom.rows, geom.cols):
                sr, sc, _ = jax.vmap(geom.index_of)(
                    positions, sensor_origin[:, :2]
                )
                r0 = jnp.clip(jnp.clip(sr, 0, geom.rows) - wr // 2,
                              0, geom.rows - wr)
                c0 = jnp.clip(jnp.clip(sc, 0, geom.cols) - wc // 2,
                              0, geom.cols - wc)
                ray_window = (r0, c0, wr, wc)
                a0, a1, r_idx, ray_in_range = jax.vmap(
                    lambda p, so, r0_, c0_: raycast.resample_indices(
                        geom, p, so, ray_num_azimuth, ray_range_bin_factor,
                        ray_max_range, window=(r0_, c0_, wr, wc),
                    )
                )(positions, sensor_origin, r0, c0)
            else:
                a0, a1, r_idx, ray_in_range = jax.vmap(
                    lambda p, so: raycast.resample_indices(
                        geom, p, so, ray_num_azimuth, ray_range_bin_factor,
                        ray_max_range,
                    )
                )(positions, sensor_origin)
            flat0 = (r_idx * ray_num_azimuth + a0).reshape(Kb, -1)
            if ray_exact_window:
                flat_idx = flat0
            else:
                flat1 = (r_idx * ray_num_azimuth + a1).reshape(Kb, -1)
                flat_idx = jnp.concatenate([flat0, flat1], axis=1)

            def rider(polar_tables):
                smeared = jax.vmap(
                    lambda so, tbl: raycast.polar_smeared_field(
                        geom, so, tbl, ray_num_azimuth,
                        ray_range_bin_factor, ray_max_range,
                        exact_window=ray_exact_window,
                    )
                )(sensor_origin, polar_tables)
                return smeared.reshape(Kb, -1), flat_idx

        obs = raster.rasterize_scatter_rows_batched(
            geom,
            positions,
            xyz_world,
            keep,
            z_var,
            intensity=intensity,
            color_packed=color_packed,
            with_voxel_count=cfg.raycasting.enabled,
            extra_min_scatter=extra,
            phase_gather_rider=rider,
            voxel_count_mode=voxel_count_mode,
        )

        ray = None
        if cfg.raycasting.enabled:
            if ray_window is not None:
                r0, c0, wr, wc = ray_window
                nwin = wr * wc
                if ray_exact_window:
                    h_cell_w = obs.extra[:, :nwin].reshape(Kb, wr, wc)
                else:
                    h_cell_w = jnp.minimum(
                        obs.extra[:, :nwin].reshape(Kb, wr, wc),
                        obs.extra[:, nwin:].reshape(Kb, wr, wc),
                    )
                touched_w = jnp.isfinite(h_cell_w) & ray_in_range
                ray_min = jax.vmap(
                    lambda h, r0_, c0_: jax.lax.dynamic_update_slice(
                        jnp.full(geom.shape, jnp.nan), h, (r0_, c0_)
                    )
                )(jnp.where(touched_w, h_cell_w, jnp.nan), r0, c0)
                ray_touched = jax.vmap(
                    lambda tw, r0_, c0_: jax.lax.dynamic_update_slice(
                        jnp.zeros(geom.shape, dtype=bool), tw, (r0_, c0_)
                    )
                )(touched_w, r0, c0)
            else:
                ncell = geom.num_cells
                if ray_exact_window:
                    h_cell = obs.extra[:, :ncell].reshape(
                        (Kb,) + geom.shape
                    )
                else:
                    h0 = obs.extra[:, :ncell].reshape((Kb,) + geom.shape)
                    h1 = obs.extra[:, ncell:].reshape((Kb,) + geom.shape)
                    h_cell = jnp.minimum(h0, h1)
                ray_touched = jnp.isfinite(h_cell) & ray_in_range
                ray_min = jnp.where(ray_touched, h_cell, jnp.nan)
            ray = (ray_min, ray_touched)

        return obs, ray, sensor_origin, xyz_world, keep, z_var, None, None

    if (
        scatter_mode != "rows"
        or windowed
        or (cfg.raycasting.enabled and cfg.raycasting.method == "sampled")
    ):
        # The batched harness does not implement the update window.
        phase_a_batched = None

    def _update_layers(state, obs, ray, sensor_origin, frame_nonempty):
        """Steps 2+3 of the map update on a (possibly window-shaped)
        state whose layer shapes match ``obs``."""
        state = _estimate(state, cfg, obs)
        state = _update_minmax(state, obs)
        state = _update_obstacle(state, obs, frame_nonempty)
        state = _update_intensity(state, obs)
        state = _update_color(state, obs)
        if cfg.raycasting.enabled:
            state = raycast.apply_raycasting(
                geom,
                state,
                None,  # xyz unused: obs_count + ray_min_touched provided
                None,
                sensor_origin,
                cfg.raycasting,
                obs_count=obs.voxel_count,
                num_azimuth=ray_num_azimuth,
                range_bin_factor=ray_range_bin_factor,
                ray_min_touched=ray,
                frame_nonempty=frame_nonempty,
            )
        return state

    def phase_b(state, T_wb, frame_nonempty, pa):
        obs, ray, sensor_origin, _xyz_world, _keep, _z_var, win_rc, _oow = pa
        # ---- 2.+3. Map update (elevation_mapping.cpp:110-125) + raycast
        # visibility (src/raycasting.cpp) ----
        if local_mode:
            state = gridmap.move(geom, state, T_wb[:2, 3])
        if not windowed:
            return _update_layers(
                state, obs, ray, sensor_origin, frame_nonempty
            )

        # Windowed update: run the identical per-cell recurrences on a
        # dynamic-sliced window of every layer, then write back. Every
        # touched cell is inside the window (build-time block above), so
        # outside cells only need the per-frame-overwrite semantics of the
        # obstacle and diagnostic ray layers: NaN when the frame is
        # nonempty (the window write-back supplies the in-window values),
        # untouched otherwise — exactly the full-map behavior.
        r0, c0 = win_rc[0], win_rc[1]
        views = {
            k: jax.lax.dynamic_slice(v, (r0, c0), (upd_wr, upd_wc))
            for k, v in state.layers.items()
        }
        vstate = GridMapState(layers=views, position=state.position)
        vstate = _update_layers(
            vstate, obs, ray, sensor_origin, frame_nonempty
        )
        overwrite_layers = (layers.obstacle, layers.raycasting)
        new_layers = {}
        for k, full in state.layers.items():
            if k in overwrite_layers:
                base = jnp.where(
                    frame_nonempty, jnp.full_like(full, jnp.nan), full
                )
            else:
                base = full
            new_layers[k] = jax.lax.dynamic_update_slice(
                base, vstate.layers[k], (r0, c0)
            )
        return GridMapState(layers=new_layers, position=state.position)

    return phase_a, phase_b, moved_position, phase_a_batched


def build_integrate_fused(
    geom: GridGeometry,
    cfg: Config,
    has_intensity: bool = False,
    has_color: bool = False,
    jit: bool = True,
    donate: bool = True,
    ray_num_azimuth: Optional[int] = None,
    ray_range_bin_factor: Optional[float] = None,
    ray_max_range: Optional[float] = None,
    ray_exact_window: bool = True,
    scatter_mode: str = "rows",
    voxel_count_mode: Optional[str] = None,
):
    """K-fused replay step: batch the irregular ops of K scans into single
    device ops, keeping only the (dense, cheap) map recurrence sequential.

    Phase A of the pipeline — preprocess,
    rasterize, polar ray field — depends only on the scan and the map
    POSITION (a pose-only lattice walk, precomputed with a tiny scan), so
    it is vmapped over K scans: XLA batches the K scatters into ONE
    scatter and the K gathers into ONE gather. Phase B (move roll,
    estimator recurrence, layer updates, raycast log-odds) stays a
    lax.scan — it is the order-dependent part and is all dense work.

    Same signature/semantics as build_integrate_sequence. Numerics: the
    vmapped phase A computes the same per-scan expressions, but XLA may
    contract FMAs differently under the batch dimension, so results can
    differ from the sequential path by float-associativity-level noise at
    discrete bin boundaries (quantified in tests/test_replay.py).

    STATUS: an A/B harness. Its speed on the GPU against
    build_integrate_sequence is not measured; prefer
    build_integrate_sequence for replay.
    """
    # The update window is pinned off (vmapped window extraction is
    # untested and the fused path is an A/B harness).
    phase_a, phase_b, moved_position, _ = _build_phases(
        geom, cfg, ray_num_azimuth, ray_range_bin_factor, ray_max_range,
        scatter_mode, voxel_count_mode, ray_exact_window,
        window_update=False,
    )
    local_mode = cfg.mapping.mode == MappingMode.LOCAL

    def fused(state, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None):
        K = xyz.shape[0]
        if local_mode:
            def pos_step(p, target):
                p2 = moved_position(p, target)
                return p2, p2

            _, positions = jax.lax.scan(
                pos_step, state.position, T_wb[:, :2, 3]
            )
        else:
            positions = jnp.broadcast_to(
                state.position, (K,) + state.position.shape
            )

        static_tbs = T_bs.ndim == 2
        pa = jax.vmap(
            phase_a,
            in_axes=(
                0, 0, 0,
                None if static_tbs else 0,
                0,
                None if intensity is None else 0,
                None if color_packed is None else 0,
            ),
        )(positions, xyz, mask, T_bs, T_wb, intensity, color_packed)

        frame_nonempty = jnp.any(mask, axis=1)

        def body(s, inp):
            pa_k, twb_k, fne_k = inp
            return phase_b(s, twb_k, fne_k, pa_k), ()

        state, _ = jax.lax.scan(body, state, (pa, T_wb, frame_nonempty))
        return state

    if jit:
        return jax.jit(fused, donate_argnums=(0,) if donate else ())
    return fused


def build_integrate_sequence(
    geom: GridGeometry,
    cfg: Config,
    has_intensity: bool = False,
    has_color: bool = False,
    jit: bool = True,
    donate: bool = True,
    microbatch: int = 1,
    **step_kwargs,
):
    """Compile a batched replay step: K scans integrated in ONE device
    program (``lax.scan`` over frames).

    The reference's offline workflow is "play the rosbag into fastdem_node"
    — one host call per scan. Offline replay stages scan batches in device
    memory and amortizes the per-dispatch host cost over K frames.

    Returned signature:
      integrate_sequence(state, xyz, mask, T_bs, T_wb,
                         intensity=None, color_packed=None) -> state
    with ``xyz`` f32[K, N, 3], ``mask`` bool[K, N], ``T_wb`` f32[K, 4, 4],
    ``T_bs`` either f32[4, 4] (static extrinsic, the common case) or
    f32[K, 4, 4], optional channels f32[K, N]. Frame k's per-scan aux is
    not materialized (K clouds of intermediates would pin K*N floats);
    callers needing aux replay the last frame through build_integrate.

    Equivalence to the per-scan loop: every decision layer (elevation,
    estimator state, log-odds, ghost clears, min/max/obstacle) matches the
    one-scan-at-a-time path exactly; the diagnostic min-ray-height layer
    may differ at isolated polar-bin boundaries because XLA contracts FMAs
    differently inside the scan body (tests/test_replay.py quantifies
    this: <=0.1% of cells, bounded by the range-bin height).

    Padding frames: replicate the previous frame's pose with an all-False
    mask — an empty scan touches no cells and a repeated pose makes LOCAL
    ``move`` a no-op, so short batches can be padded to a fixed K without
    affecting the map.

    ``microbatch``: flatten the irregular ops (scatters/gathers) of this
    many consecutive scans into single flat offset-index device ops
    (rasterize_scatter_rows_batched; phase B stays a per-frame scan). K
    must be a multiple of it. Requires the "rows" scatter path; falls back
    to 1 (with a warning) when the configuration can't use it. Whether >1
    wins is not measured on the GPU: the K-fold larger scatter/gather
    tables trade against fewer, larger irregular ops.
    """
    if microbatch < 1:
        raise ValueError("microbatch must be >= 1")
    if microbatch > 1:
        pa_kwargs = dict(step_kwargs)
        pa_kwargs.setdefault("scatter_mode", "rows")
        # The batched harness does not implement the update window — pin
        # it off (microbatch>1 implies full-map updates).
        phase_a, phase_b, moved_position, phase_a_batched = _build_phases(
            geom,
            cfg,
            pa_kwargs.get("ray_num_azimuth"),
            pa_kwargs.get("ray_range_bin_factor"),
            pa_kwargs.get("ray_max_range"),
            pa_kwargs.get("scatter_mode", "rows"),
            pa_kwargs.get("voxel_count_mode"),
            pa_kwargs.get("ray_exact_window", True),
            window_update=False,
        )
        if microbatch * (geom.num_cells + 1) > (1 << 21):
            raise ValueError(
                f"microbatch={microbatch} over {geom.num_cells} cells "
                "would build a scatter table past 2^21 rows; reduce "
                "microbatch or the map size"
            )
        if phase_a_batched is None:
            import logging

            logging.getLogger("fastdem_tpu").warning(
                "microbatch=%d needs the 'rows' scatter path (without the "
                "sampled raycast method); falling back to sequential "
                "phase A.",
                microbatch,
            )
            microbatch = 1
    if microbatch > 1:
        local_mode = cfg.mapping.mode == MappingMode.LOCAL
        mb = microbatch

        def integrate_sequence(
            state, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None
        ):
            K = xyz.shape[0]
            if K % mb:
                raise ValueError(
                    f"K={K} frames not a multiple of microbatch={mb}; pad "
                    "with empty frames (see docstring)"
                )
            static_tbs = T_bs.ndim == 2

            def chunked(a):
                return (
                    None
                    if a is None
                    else a.reshape((K // mb, mb) + a.shape[1:])
                )

            xs = {
                "xyz": chunked(xyz),
                "mask": chunked(mask),
                "T_wb": chunked(T_wb),
            }
            if not static_tbs:
                xs["T_bs"] = chunked(T_bs)
            if intensity is not None:
                xs["intensity"] = chunked(intensity)
            if color_packed is not None:
                xs["color"] = chunked(color_packed)

            def chunk_body(s, inp):
                twb_c = inp["T_wb"]
                if local_mode:
                    def pos_step(p, target):
                        p2 = moved_position(p, target)
                        return p2, p2

                    _, positions = jax.lax.scan(
                        pos_step, s.position, twb_c[:, :2, 3]
                    )
                else:
                    positions = jnp.broadcast_to(
                        s.position, (mb,) + s.position.shape
                    )
                pa = phase_a_batched(
                    positions,
                    inp["xyz"],
                    inp["mask"],
                    T_bs if static_tbs else inp["T_bs"],
                    twb_c,
                    inp.get("intensity"),
                    inp.get("color"),
                )
                fne = jnp.any(inp["mask"], axis=1)

                def frame_body(s2, fr):
                    pa_k, twb_k, fne_k = fr
                    return phase_b(s2, twb_k, fne_k, pa_k), ()

                s, _ = jax.lax.scan(frame_body, s, (pa, twb_c, fne))
                return s, ()

            state, _ = jax.lax.scan(chunk_body, state, xs)
            return state

        if jit:
            return jax.jit(
                integrate_sequence, donate_argnums=(0,) if donate else ()
            )
        return integrate_sequence

    step = build_integrate(
        geom, cfg, has_intensity, has_color, jit=False, **step_kwargs
    )

    def integrate_sequence(
        state, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None
    ):
        static_tbs = T_bs.ndim == 2
        xs = {"xyz": xyz, "mask": mask, "T_wb": T_wb}
        if not static_tbs:
            xs["T_bs"] = T_bs
        if intensity is not None:
            xs["intensity"] = intensity
        if color_packed is not None:
            xs["color"] = color_packed

        def body(s, inp):
            s, _ = step(
                s,
                inp["xyz"],
                inp["mask"],
                T_bs if static_tbs else inp["T_bs"],
                inp["T_wb"],
                inp.get("intensity"),
                inp.get("color"),
            )
            return s, ()

        state, _ = jax.lax.scan(body, state, xs)
        return state

    if jit:
        return jax.jit(
            integrate_sequence, donate_argnums=(0,) if donate else ()
        )
    return integrate_sequence


# ---------------------------------------------------------------------------
# Stateful convenience facade (mirrors the reference FastDEM class surface,
# include/fastdem/fastdem.hpp:54-160). Keeps the jitted step + host metadata.
# ---------------------------------------------------------------------------


class FastDEM:
    """Host-side facade: owns the map state and the compiled step.

    Not thread-safe, like the reference (fastdem.hpp:49-53); the runtime
    driver serializes access.
    """

    def __init__(
        self,
        geom: GridGeometry,
        cfg: Optional[Config] = None,
        position=(0.0, 0.0),
        frame_id: str = "map",
        has_intensity: bool = False,
        has_color: bool = False,
        auto_bucket: bool = True,
    ):
        self.geom = geom
        self.cfg = cfg or Config()
        self.frame_id = frame_id
        self.has_intensity = has_intensity
        self.has_color = has_color
        # Compact+pad scans to the geometric capacity ladder when their
        # valid count sits well below capacity (RGB-D invalid depth);
        # see integrate() and cloud.pointcloud.compact_to_bucket.
        self.auto_bucket = auto_bucket
        self._origin = tuple(position)
        self.state = create_map_state(
            geom, self.cfg, position, has_intensity, has_color
        )
        # No donation in the interactive facade: concurrent readers (the
        # driver's snapshot/viz timers) may still hold the previous state,
        # and donating would invalidate their buffers mid-read. The extra
        # copy is a few MB; latency-critical loops should use
        # build_integrate(donate=True) with exclusive buffer ownership.
        # Base->sensor translation allowance baked into the update-window /
        # polar-field bounds; widened automatically (with a step rebuild)
        # when a larger extrinsic shows up (a 3 m boom must widen the
        # window or warn, never silently drop points).
        self._window_margin = 2.0
        self._oow_check_every = 64
        self._scan_counter = 0
        self._step = build_integrate(
            geom, self.cfg, has_intensity, has_color, donate=False,
            window_margin=self._window_margin,
        )
        self.calibration = None  # Calibration provider (transform_interface)
        self.odometry = None  # Odometry provider
        self.on_preprocessed = None
        self.on_rasterized = None
        self.last_aux: Optional[IntegrateAux] = None
        # Batched-replay programs keyed by (K, N, channels); cleared on
        # config rebuilds.
        self._seq_cache = {}

    # -- fluent setters (fastdem.cpp:28-77): each rebuilds the step ----------
    def _rebuild(self):
        self._step = build_integrate(
            self.geom, self.cfg, self.has_intensity, self.has_color,
            donate=False, window_margin=self._window_margin,
        )
        self._seq_cache.clear()
        # Estimator/raycast layer sets may change; merge-preserving rebuild
        # (ensureLayers is exists-guarded in the reference).
        fills = initial_layer_fills(self.cfg, self.has_intensity, self.has_color)
        lyr = dict(self.state.layers)
        for name, fill in fills.items():
            if name not in lyr:
                lyr[name] = jnp.full(self.geom.shape, fill, dtype=jnp.float32)
        self.state = GridMapState(layers=lyr, position=self.state.position)

    def set_mapping_mode(self, mode: MappingMode) -> "FastDEM":
        self.cfg.mapping.mode = mode
        self._rebuild()
        return self

    def set_estimator_type(self, est: EstimationType) -> "FastDEM":
        self.cfg.mapping.estimation_type = est
        self._rebuild()
        return self

    def set_sensor_model(self, sensor_type) -> "FastDEM":
        self.cfg.sensor_model.type = sensor_type
        self._rebuild()
        return self

    def set_height_filter(self, z_min: float, z_max: float) -> "FastDEM":
        self.cfg.point_filter.z_min = z_min
        self.cfg.point_filter.z_max = z_max
        self._rebuild()
        return self

    def set_range_filter(self, rmin: float, rmax: float) -> "FastDEM":
        self.cfg.point_filter.range_min = rmin
        self.cfg.point_filter.range_max = rmax
        self._rebuild()
        return self

    def enable_raycasting(self, enabled: bool = True) -> "FastDEM":
        self.cfg.raycasting.enabled = enabled
        self._rebuild()
        return self

    def set_calibration_provider(self, provider) -> "FastDEM":
        self.calibration = provider
        return self

    def set_odometry_provider(self, provider) -> "FastDEM":
        self.odometry = provider
        return self

    def has_transform_provider(self) -> bool:
        return self.calibration is not None and self.odometry is not None

    def reset(self) -> None:
        """clearAll (fastdem.cpp:26)."""
        self.state = gridmap.clear_all(self.state)

    # -- integration ---------------------------------------------------------
    def integrate(self, cloud, T_base_sensor=None, T_world_base=None) -> bool:
        """Integrate one scan. With explicit transforms this mirrors
        FastDEM::integrate(cloud, T_bs, T_wb) (fastdem.cpp:122-131); without,
        the providers are queried (fastdem.cpp:83-120). Returns False and
        drops the scan on any failure (the reference's per-scan fault
        tolerance)."""
        import logging

        log = logging.getLogger("fastdem_tpu")

        if T_base_sensor is None or T_world_base is None:
            if not self.has_transform_provider():
                log.error(
                    "[FastDEM] Transform providers not set; use explicit "
                    "transforms or set providers first."
                )
                return False
            if cloud is None or cloud.empty():
                log.warning("[FastDEM] Received empty or null cloud. Skipping...")
                return False
            if not cloud.frame_id:
                log.error("[FastDEM] Input cloud has no frameId. Skipping...")
                return False
            T_base_sensor = self.calibration.get_extrinsic(cloud.frame_id)
            if T_base_sensor is None:
                log.warning(
                    "[FastDEM] Calibration not available for '%s'. Skipping...",
                    cloud.frame_id,
                )
                return False
            T_world_base = self.odometry.get_pose_at(cloud.timestamp_ns)
            if T_world_base is None:
                log.warning(
                    "[FastDEM] Odometry not available at %d. Skipping...",
                    cloud.timestamp_ns,
                )
                return False
        elif cloud is None or cloud.empty():
            import logging

            logging.getLogger("fastdem_tpu").warning(
                "[FastDEM] Received empty cloud. Skipping..."
            )
            return False

        # Auto bucket selection: scatter cost is linear in
        # CAPACITY whether rows are masked or not, so a frame whose valid
        # count sits a ladder bucket (or more) below its capacity — the
        # RGB-D invalid-depth case — is truly compacted host-side and run
        # through the next ladder program. Order-preserving compaction
        # keeps rasterizer tie winners (see compact_to_bucket on the
        # exactness envelope); each ladder capacity compiles once and is
        # reused.
        if (
            self.auto_bucket
            and cloud.valid_count >= 0
            and pc.ladder_capacity(cloud.valid_count) < cloud.capacity * 0.75
        ):
            cloud = pc.compact_to_bucket(cloud)

        intensity = cloud.channels.get("intensity") if self.has_intensity else None
        color_packed = None
        if self.has_color and "color" in cloud.channels:
            from fastdem_tpu.utils.colors import pack_rgb

            color_packed = pack_rgb(cloud.channels["color"])

        # Window-margin guard: the update-window bound assumes the
        # base->sensor xy offset stays under the built margin. Widen (one
        # recompile) BEFORE integrating rather than silently dropping
        # points past the window.
        off = float(np.hypot(float(T_base_sensor[0][3]),
                             float(T_base_sensor[1][3])))
        if off + 0.5 > self._window_margin:
            log = logging.getLogger("fastdem_tpu")
            log.warning(
                "[FastDEM] base->sensor xy offset %.2f m exceeds the "
                "window margin %.2f m; widening to %.2f m (recompile).",
                off, self._window_margin, off + 1.0,
            )
            self._window_margin = off + 1.0
            self._rebuild()

        T_bs = jnp.asarray(T_base_sensor, dtype=jnp.float32)
        T_wb = jnp.asarray(T_world_base, dtype=jnp.float32)
        self.state, aux = self._step(
            self.state, cloud.xyz, cloud.mask, T_bs, T_wb,
            intensity, color_packed,
        )
        self.last_aux = aux
        # Backstop for paths the extrinsic guard can't see (e.g. dynamic
        # extrinsics): periodically fetch the out-of-window point count.
        self._scan_counter += 1
        if (
            aux.oow_points is not None
            and self._scan_counter % self._oow_check_every == 0
        ):
            n_oow = int(aux.oow_points)
            if n_oow:
                logging.getLogger("fastdem_tpu").error(
                    "[FastDEM] %d in-map points fell OUTSIDE the update "
                    "window this scan and were dropped — base->sensor "
                    "offset exceeds the window margin (%.2f m); widen it "
                    "or check extrinsics.", n_oow, self._window_margin,
                )
        if self.on_preprocessed is not None:
            self.on_preprocessed(aux)
        if self.on_rasterized is not None:
            self.on_rasterized(self.rasterized_cloud(aux))
        return True

    def integrate_sequence(
        self, clouds, T_base_sensor=None, T_world_base=None, batch: int = 16
    ) -> int:
        """Integrate a list of scans with batched device programs.

        Offline-replay counterpart of ``integrate`` (the reference workflow
        "play a rosbag into fastdem_node", ros2/src/fastdem_ros_node.cpp:178):
        scans are staged in HBM and integrated ``batch`` frames per dispatch
        (build_integrate_sequence), amortizing the per-dispatch host round
        trip. Map state after the call matches calling ``integrate`` per
        cloud in order (exact on every decision layer; see
        build_integrate_sequence on the diagnostic ray layer).

        Transforms follow ``integrate``'s rule: explicit mode requires
        BOTH ``T_base_sensor`` (one 4x4 or [K, 4, 4]) and ``T_world_base``
        (a [K, 4, 4] array / list); if either is missing the providers are
        queried per cloud (failed lookups drop that scan, like the
        reference). Clouds are padded to one bucketed capacity; short final
        chunks are padded with empty frames replicating the last pose (a
        provable no-op). Channels are used only when every accepted cloud
        carries them. Returns the number of scans integrated; ``last_aux``
        is not updated (per-frame aux is not materialized in batch mode).
        """
        import logging

        log = logging.getLogger("fastdem_tpu")
        if batch < 1:
            raise ValueError("batch must be >= 1")

        # Same rule as integrate() (fastdem.cpp:83-131): explicit mode
        # needs BOTH transforms, otherwise the providers are queried.
        explicit = T_base_sensor is not None and T_world_base is not None
        if explicit:
            T_wb_all = np.asarray(T_world_base, dtype=np.float32).reshape(
                -1, 4, 4
            )
            if T_wb_all.shape[0] != len(clouds):
                raise ValueError(
                    "T_world_base must provide one pose per cloud"
                )
            tbs_arr = np.asarray(T_base_sensor, dtype=np.float32)
            static_tbs = tbs_arr.shape == (4, 4)
            if not static_tbs:
                tbs_arr = tbs_arr.reshape(-1, 4, 4)
                if tbs_arr.shape[0] != len(clouds):
                    raise ValueError(
                        "T_base_sensor must be one 4x4 or one per cloud"
                    )
        elif not self.has_transform_provider():
            log.error(
                "[FastDEM] Transform providers not set; use explicit "
                "transforms or set providers first."
            )
            return 0

        items = []  # (cloud, T_bs 4x4 np, T_wb 4x4 np)
        for i, cloud in enumerate(clouds):
            if cloud is None or cloud.empty():
                log.warning("[FastDEM] Empty cloud at %d. Skipping...", i)
                continue
            if explicit:
                tbs = tbs_arr if static_tbs else tbs_arr[i]
                twb = T_wb_all[i]
            else:
                if not cloud.frame_id:
                    log.error(
                        "[FastDEM] Cloud %d has no frameId. Skipping...", i
                    )
                    continue
                tbs = self.calibration.get_extrinsic(cloud.frame_id)
                if tbs is None:
                    log.warning(
                        "[FastDEM] Calibration not available for '%s'. "
                        "Skipping...",
                        cloud.frame_id,
                    )
                    continue
                twb = self.odometry.get_pose_at(cloud.timestamp_ns)
                if twb is None:
                    log.warning(
                        "[FastDEM] Odometry not available at %d. Skipping...",
                        cloud.timestamp_ns,
                    )
                    continue
            items.append((cloud, np.asarray(tbs, np.float32),
                          np.asarray(twb, np.float32)))
        if not items:
            return 0

        from fastdem_tpu.cloud.pointcloud import (
            bucket_capacity,
            compact_to_bucket,
            ladder_capacity,
            pad_to,
        )

        # Auto bucket selection, batch flavor: when every
        # accepted cloud's valid count is known and the whole batch fits a
        # ladder capacity well below the raw one (heavily masked RGB-D
        # logs), compact each cloud — scatter cost is linear in capacity,
        # so the whole replay runs at the valid-count price.
        if self.auto_bucket:
            vcs = [c.valid_count for c, _, _ in items]
            raw_cap = max(c.capacity for c, _, _ in items)
            if (
                all(v >= 0 for v in vcs)
                and ladder_capacity(max(vcs)) < raw_cap * 0.75
            ):
                items = [
                    (compact_to_bucket(c), tbs, twb)
                    for c, tbs, twb in items
                ]

        cap = bucket_capacity(max(c.capacity for c, _, _ in items))
        use_int = self.has_intensity and all(
            c.has("intensity") for c, _, _ in items
        )
        use_col = self.has_color and all(c.has("color") for c, _, _ in items)
        if self.has_intensity and not use_int and any(
            c.has("intensity") for c, _, _ in items
        ):
            log.warning(
                "[FastDEM] Mixed intensity presence across the batch; "
                "ignoring the channel for this call."
            )
        if self.has_color and not use_col and any(
            c.has("color") for c, _, _ in items
        ):
            log.warning(
                "[FastDEM] Mixed color presence across the batch; "
                "ignoring the channel for this call."
            )

        key = (batch, cap, use_int, use_col)
        fn = self._seq_cache.get(key)
        if fn is None:
            fn = build_integrate_sequence(
                self.geom, self.cfg, use_int, use_col, donate=False
            )
            self._seq_cache[key] = fn

        if use_col:
            from fastdem_tpu.utils.colors import pack_rgb

        for lo in range(0, len(items), batch):
            chunk = items[lo : lo + batch]
            pad_frames = batch - len(chunk)
            padded = [pad_to(c, cap) for c, _, _ in chunk]
            xyz = jnp.stack([c.xyz for c in padded])
            mask = jnp.stack([c.mask for c in padded])
            tbs = np.stack([t for _, t, _ in chunk])
            twb = np.stack([t for _, _, t in chunk])
            if pad_frames:
                xyz = jnp.concatenate(
                    [xyz, jnp.broadcast_to(xyz[-1:], (pad_frames,) + xyz.shape[1:])]
                )
                mask = jnp.concatenate(
                    [mask, jnp.zeros((pad_frames, cap), dtype=bool)]
                )
                tbs = np.concatenate([tbs, np.repeat(tbs[-1:], pad_frames, 0)])
                twb = np.concatenate([twb, np.repeat(twb[-1:], pad_frames, 0)])
            intensity = (
                jnp.stack([c.channels["intensity"] for c in padded])
                if use_int
                else None
            )
            if use_int and pad_frames:
                intensity = jnp.concatenate(
                    [
                        intensity,
                        jnp.zeros((pad_frames, cap), dtype=intensity.dtype),
                    ]
                )
            color = (
                jnp.stack([pack_rgb(c.channels["color"]) for c in padded])
                if use_col
                else None
            )
            if use_col and pad_frames:
                color = jnp.concatenate(
                    [color, jnp.zeros((pad_frames, cap), dtype=color.dtype)]
                )
            self.state = fn(
                self.state,
                xyz,
                mask,
                jnp.asarray(tbs),
                jnp.asarray(twb),
                intensity,
                color,
            )
        return len(items)

    def rasterized_cloud(self, aux: IntegrateAux):
        """One point per touched cell at (cell center, min_z) — the
        onScanRasterized payload (fastdem.cpp:200-214)."""
        x, y = self.geom.cell_centers(self.state.position)
        touched = aux.obs.touched
        return x, y, aux.obs.min_z, touched
