"""Point-cloud filters as mask updates and sort-based reductions.

nanoPCL-filter equivalents
(/root/reference/fastdem/lib/nanoPCL/include/nanopcl/filters/):
  * crop box / range / X / Y / Z / angle with INSIDE/OUTSIDE modes
    (impl/crop_impl.hpp: inclusive bounds for INSIDE) -> pure mask updates.
  * voxelGrid with CENTROID / NEAREST / ANY / CENTER modes
    (impl/voxel_grid_impl.hpp:30-100: pack key, sort, per-voxel reduce).
  * gridMaxZ (keep highest point per 2D cell).
  * deskew (per-point pose interpolation, filters/deskew.hpp:72-129).

Design:
  * Filters NEVER compact (XLA static shapes); they intersect ``mask``.
    Use pointcloud.compact() on the host when an exact-size cloud is needed.
  * The reference packs voxel coords into a 64-bit key and sorts
    (core/voxel.hpp:28-43). Without 64-bit integers we sort lexicographically
    on (iz, iy, ix, original_index) int32 keys via jax.lax.sort — exact, and
    the trailing index key makes the representative deterministic (lowest
    original index per voxel, a refinement of the reference's 'ANY').
  * Per-voxel reductions are jax.ops.segment_* over sorted segment ids.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import jax
import jax.numpy as jnp

from fastdem_tpu.cloud import transform as tfm
from fastdem_tpu.cloud.pointcloud import PointCloud


class FilterMode(enum.Enum):
    INSIDE = "inside"
    OUTSIDE = "outside"


class VoxelMode(enum.Enum):
    CENTROID = "centroid"
    NEAREST = "nearest"
    ANY = "any"
    CENTER = "center"


def _apply(cloud: PointCloud, keep: jnp.ndarray, mode: FilterMode) -> PointCloud:
    if mode == FilterMode.OUTSIDE:
        keep = ~keep
    return cloud.with_mask(cloud.mask & keep)


# ---------------------------------------------------------------------------
# Crop family (inclusive INSIDE bounds, matching crop_impl.hpp)
# ---------------------------------------------------------------------------


def crop_box(
    cloud: PointCloud, min_pt, max_pt, mode: FilterMode = FilterMode.INSIDE
) -> PointCloud:
    lo = jnp.asarray(min_pt, dtype=jnp.float32)
    hi = jnp.asarray(max_pt, dtype=jnp.float32)
    keep = jnp.all((cloud.xyz >= lo) & (cloud.xyz <= hi), axis=-1)
    return _apply(cloud, keep, mode)


def crop_range(
    cloud: PointCloud,
    min_range: float,
    max_range: float,
    mode: FilterMode = FilterMode.INSIDE,
) -> PointCloud:
    d2 = jnp.sum(cloud.xyz * cloud.xyz, axis=-1)
    keep = (d2 >= min_range * min_range) & (d2 <= max_range * max_range)
    return _apply(cloud, keep, mode)


def _crop_axis(cloud, axis, lo, hi, mode):
    v = cloud.xyz[:, axis]
    return _apply(cloud, (v >= lo) & (v <= hi), mode)


def crop_x(cloud, lo, hi, mode=FilterMode.INSIDE):
    return _crop_axis(cloud, 0, lo, hi, mode)


def crop_y(cloud, lo, hi, mode=FilterMode.INSIDE):
    return _crop_axis(cloud, 1, lo, hi, mode)


def crop_z(cloud, lo, hi, mode=FilterMode.INSIDE):
    return _crop_axis(cloud, 2, lo, hi, mode)


def crop_angle(
    cloud: PointCloud,
    min_angle: float,
    max_angle: float,
    mode: FilterMode = FilterMode.INSIDE,
) -> PointCloud:
    """Azimuth FOV crop; half-plane cross-product formulation identical to
    crop_impl.hpp:184-205 (handles wrap-around, eps=1e-5)."""
    import math

    cos_min, sin_min = math.cos(min_angle), math.sin(min_angle)
    cos_max, sin_max = math.cos(max_angle), math.sin(max_angle)
    wrap = min_angle > max_angle
    rng = (2 * math.pi - (min_angle - max_angle)) if wrap else (max_angle - min_angle)
    use_and = rng < math.pi
    eps = 1e-5
    x, y = cloud.xyz[:, 0], cloud.xyz[:, 1]
    c_min = cos_min * y - sin_min * x
    c_max = cos_max * y - sin_max * x
    in_range = (
        (c_min >= -eps) & (c_max <= eps)
        if use_and
        else (c_min >= -eps) | (c_max <= eps)
    )
    return _apply(cloud, in_range, mode)


# ---------------------------------------------------------------------------
# Voxel grid downsampling
# ---------------------------------------------------------------------------


def voxel_coords(xyz: jnp.ndarray, voxel_size: float) -> jnp.ndarray:
    """Integer voxel coordinates i32[N, 3] (core/voxel.hpp pack without the
    bit-packing: we keep components separate for lexicographic sort)."""
    return jnp.floor(xyz / voxel_size).astype(jnp.int32)


VOXEL_KEY_BITS = 1024  # 1024^3 = 2^30 keys: fits int32 without wrap


def voxel_key(coords: jnp.ndarray) -> jnp.ndarray:
    """Pack i32[N, 3] voxel coordinates into one sortable i32 key
    (clipped to +-512 per axis). The SINGLE encoding shared by VGICP's
    voxel-distribution map and its correspondence lookup — both sides
    must agree bit-for-bit or points silently stop matching voxels."""
    B = VOXEL_KEY_BITS
    return (
        (jnp.clip(coords[..., 0] + B // 2, 0, B - 1) * B
         + jnp.clip(coords[..., 1] + B // 2, 0, B - 1)) * B
        + jnp.clip(coords[..., 2] + B // 2, 0, B - 1)
    )


def voxel_unique_mask(
    xyz: jnp.ndarray, mask: jnp.ndarray, voxel_size: float
) -> jnp.ndarray:
    """Array-level voxelGrid(ANY): mask keeping one representative point per
    3D voxel (lowest original index). Used by the raycasting downsample
    (reference src/fastdem.cpp:156-158) inside jitted pipelines."""
    coords = voxel_coords(xyz, voxel_size)
    order, seg, is_head, valid_s = _voxel_sort(mask, coords)
    keep = jnp.zeros(xyz.shape[0], dtype=bool).at[order].set(is_head)
    return mask & keep


def _voxel_sort(mask: jnp.ndarray, coords: jnp.ndarray):
    """Sort points lexicographically by (masked-last, vz, vy, vx, index).

    Returns (order, seg_id, is_head, valid_sorted) where seg_id is the dense
    segment id per sorted position and is_head marks the first point of each
    voxel. Invalid points sort to the tail and get seg ids beyond any valid
    segment.
    """
    n = coords.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    invalid = (~mask).astype(jnp.int32)
    kz, ky, kx = coords[:, 2], coords[:, 1], coords[:, 0]
    # lax.sort: lexicographic over the first num_keys operands.
    sorted_ops = jax.lax.sort(
        (invalid, kz, ky, kx, idx), num_keys=4, is_stable=True
    )
    inv_s, kz_s, ky_s, kx_s, order = sorted_ops
    valid_s = inv_s == 0
    new_key = (
        (kz_s != jnp.roll(kz_s, 1))
        | (ky_s != jnp.roll(ky_s, 1))
        | (kx_s != jnp.roll(kx_s, 1))
    )
    is_head = valid_s & (new_key.at[0].set(True))
    # Dense segment id (0-based) per sorted position; invalid tail -> n.
    seg = jnp.cumsum(is_head.astype(jnp.int32)) - 1
    seg = jnp.where(valid_s, seg, n)
    return order, seg, is_head, valid_s


def voxel_grid(
    cloud: PointCloud, voxel_size: float, mode: VoxelMode = VoxelMode.ANY
) -> PointCloud:
    """Voxel-grid downsample. Output keeps the input capacity; surviving
    points are the per-voxel representatives (mask marks them)."""
    coords = voxel_coords(cloud.xyz, voxel_size)
    order, seg, is_head, valid_s = _voxel_sort(cloud.mask, coords)
    n = cloud.capacity

    if mode == VoxelMode.ANY:
        # Representative = lowest-index point per voxel (deterministic 'ANY').
        keep_sorted = is_head
        keep = jnp.zeros(n, dtype=bool).at[order].set(keep_sorted)
        return cloud.with_mask(cloud.mask & keep)

    xyz_s = cloud.xyz[order]
    ones = valid_s.astype(jnp.float32)
    cnt = jax.ops.segment_sum(ones, seg, num_segments=n + 1)[:n]
    sums = jax.ops.segment_sum(
        xyz_s * ones[:, None], seg, num_segments=n + 1
    )[:n]
    centroid = sums / jnp.maximum(cnt, 1.0)[:, None]

    if mode == VoxelMode.NEAREST:
        # Point closest to its voxel centroid.
        d2 = jnp.sum((xyz_s - centroid[jnp.minimum(seg, n - 1)]) ** 2, axis=-1)
        d2 = jnp.where(valid_s, d2, jnp.inf)
        best = jax.ops.segment_min(d2, seg, num_segments=n + 1)[:n]
        is_best = valid_s & (d2 <= best[jnp.minimum(seg, n - 1)])
        # Tie-break: keep only the first best in each segment.
        first_best_pos = jax.ops.segment_min(
            jnp.where(is_best, jnp.arange(n), n), seg, num_segments=n + 1
        )[:n]
        keep_sorted = is_best & (
            jnp.arange(n) == first_best_pos[jnp.minimum(seg, n - 1)]
        )
        keep = jnp.zeros(n, dtype=bool).at[order].set(keep_sorted)
        return cloud.with_mask(cloud.mask & keep)

    # CENTROID / CENTER synthesize new points at the head slots.
    head_seg = jnp.minimum(seg, n - 1)
    if mode == VoxelMode.CENTER:
        new_xyz_sorted = (coords[order].astype(jnp.float32) + 0.5) * voxel_size
    else:  # CENTROID
        new_xyz_sorted = centroid[head_seg]

    out_xyz = cloud.xyz.at[order].set(
        jnp.where(is_head[:, None], new_xyz_sorted, cloud.xyz[order])
    )
    keep = jnp.zeros(n, dtype=bool).at[order].set(is_head)
    out = dataclasses.replace(cloud, xyz=out_xyz, mask=cloud.mask & keep)

    if mode == VoxelMode.CENTROID:
        # Mean intensity/time/color/normal per voxel (voxel_grid_impl.hpp
        # CENTROID branch); ring/label keep the head point's value.
        ch = dict(out.channels)
        for name in ("intensity", "time"):
            if name in ch:
                v = ch[name][order].astype(jnp.float32)
                m = jax.ops.segment_sum(v * ones, seg, num_segments=n + 1)[:n]
                mean = (m / jnp.maximum(cnt, 1.0))[head_seg]
                ch[name] = ch[name].at[order].set(
                    jnp.where(is_head, mean, ch[name][order])
                )
        if "color" in ch:
            v = ch["color"][order].astype(jnp.float32)
            m = jax.ops.segment_sum(v * ones[:, None], seg, num_segments=n + 1)[:n]
            mean = (m / jnp.maximum(cnt, 1.0)[:, None])[head_seg]
            ch["color"] = ch["color"].at[order].set(
                jnp.where(
                    is_head[:, None], mean.astype(jnp.uint8), ch["color"][order]
                )
            )
        if "normal" in ch:
            v = ch["normal"][order]
            m = jax.ops.segment_sum(v * ones[:, None], seg, num_segments=n + 1)[:n]
            norm = jnp.linalg.norm(m, axis=-1, keepdims=True)
            mean = (m / jnp.maximum(norm, 1e-12))[head_seg]
            ch["normal"] = ch["normal"].at[order].set(
                jnp.where(is_head[:, None], mean, ch["normal"][order])
            )
        out = dataclasses.replace(out, channels=ch)
    return out


def grid_max_z(cloud: PointCloud, cell_size: float) -> PointCloud:
    """Keep the highest point per 2D (x, y) cell (nanoPCL gridMaxZ)."""
    n = cloud.capacity
    coords2 = jnp.floor(cloud.xyz[:, :2] / cell_size).astype(jnp.int32)
    coords = jnp.concatenate(
        [coords2, jnp.zeros((n, 1), dtype=jnp.int32)], axis=1
    )
    order, seg, is_head, valid_s = _voxel_sort(cloud.mask, coords)
    z_s = jnp.where(valid_s, cloud.xyz[order][:, 2], -jnp.inf)
    zmax = jax.ops.segment_max(z_s, seg, num_segments=n + 1)[:n]
    head_seg = jnp.minimum(seg, n - 1)
    is_max = valid_s & (z_s >= zmax[head_seg])
    first_pos = jax.ops.segment_min(
        jnp.where(is_max, jnp.arange(n), n), seg, num_segments=n + 1
    )[:n]
    keep_sorted = is_max & (jnp.arange(n) == first_pos[head_seg])
    keep = jnp.zeros(n, dtype=bool).at[order].set(keep_sorted)
    return cloud.with_mask(cloud.mask & keep)


# ---------------------------------------------------------------------------
# Deskew (motion compensation)
# ---------------------------------------------------------------------------


def deskew(
    cloud: PointCloud,
    T_start: jnp.ndarray,
    T_end: jnp.ndarray,
    t0: float | jnp.ndarray | None = None,
    t1: float | jnp.ndarray | None = None,
    strategy: str = "channel",
) -> PointCloud:
    """Per-point motion compensation (nanopcl filters/deskew.hpp:72-129).

    Each point is transformed by T_end^-1 * T(t) — the relative motion
    from its capture pose (slerp rotation, lerp translation at its
    normalized time within [t0, t1]) into the END-of-scan frame, like the
    reference (impl/deskew_impl.hpp:27-46: T_rel = T_end_inv * T_point);
    the output stays in the sensor frame. Matching the reference
    overloads:
      * explicit t0/t1 — absolute-timestamp time channel (deskew.hpp:121+)
      * strategy="channel" (default) — t0/t1 auto-detected as the valid
        min/max of the 'time' channel
      * strategy="index" — points assumed in temporal order; alpha = i/(N-1)
    Points outside [t0, t1] clamp to the endpoints.
    """
    if strategy == "index":
        n = cloud.capacity
        alpha = jnp.arange(n, dtype=jnp.float32) / max(n - 1, 1)
    elif "time" not in cloud.channels:
        return cloud  # T_rel(t_end) = identity: nothing to compensate
    else:
        t = cloud.channels["time"]
        if t0 is None:
            t0 = jnp.min(jnp.where(cloud.mask, t, jnp.inf))
        if t1 is None:
            t1 = jnp.max(jnp.where(cloud.mask, t, -jnp.inf))
        alpha = jnp.clip((t - t0) / jnp.maximum(t1 - t0, 1e-12), 0.0, 1.0)
    q0 = tfm.quat_from_matrix(T_start[:3, :3])
    q1 = tfm.quat_from_matrix(T_end[:3, :3])
    q = tfm.slerp(q0, q1, alpha)  # [N, 4]
    R = jax.vmap(tfm.matrix_from_quat)(q)  # [N, 3, 3]
    trans = (1 - alpha)[:, None] * T_start[:3, 3] + alpha[:, None] * T_end[:3, 3]
    # p' = T_end^-1 * (R(t) p + t(t))
    R_end_inv = T_end[:3, :3].T
    world = jnp.einsum("nij,nj->ni", R, cloud.xyz, precision=tfm.HIGHEST)
    world = world + trans
    xyz = jnp.matmul(
        world - T_end[:3, 3], R_end_inv.T, precision=tfm.HIGHEST
    )
    out = dataclasses.replace(cloud, xyz=xyz)
    if "normal" in cloud.channels:
        nrm = cloud.channels["normal"]
        n3 = jnp.einsum(
            "ij,njk,nk->ni", R_end_inv, R, nrm[:, :3], precision=tfm.HIGHEST
        )
        out = out.with_channel(
            "normal", nrm.at[:, :3].set(n3) if nrm.shape[1] == 4 else n3
        )
    return out


def deskew_lookup(cloud: PointCloud, pose_lookup, num_waypoints: int = 16) -> PointCloud:
    """Deskew with an arbitrary pose-lookup callable (deskew.hpp:72-75).

    ``pose_lookup(t: float) -> 4x4`` is sampled on the host at
    ``num_waypoints`` times spanning the scan's time channel; per-point
    poses interpolate (slerp/lerp) between the bracketing waypoints on the
    device — trajectories far from piecewise-linear need more waypoints.
    """
    import numpy as np

    if "time" not in cloud.channels:
        raise ValueError("deskew_lookup requires a 'time' channel")
    t_host = np.asarray(cloud.channels["time"])
    m_host = np.asarray(cloud.mask)
    if not m_host.any():
        return cloud
    t0 = float(t_host[m_host].min())
    t1 = float(t_host[m_host].max())
    W = max(2, num_waypoints)
    ts = np.linspace(t0, t1, W)
    poses = np.stack([np.asarray(pose_lookup(float(t))) for t in ts])
    quats = jnp.stack(
        [tfm.quat_from_matrix(jnp.asarray(P[:3, :3], jnp.float32)) for P in poses]
    )  # [W, 4]
    trans_w = jnp.asarray(poses[:, :3, 3], jnp.float32)  # [W, 3]

    t = cloud.channels["time"]
    u = jnp.clip((t - t0) / max(t1 - t0, 1e-12), 0.0, 1.0) * (W - 1)
    i0 = jnp.clip(u.astype(jnp.int32), 0, W - 2)
    frac = u - i0.astype(jnp.float32)

    qa = quats[i0]  # [N, 4]
    qb = quats[i0 + 1]
    # Pairwise slerp with per-point quaternion pairs.
    d = jnp.sum(qa * qb, axis=-1)
    qb = jnp.where(d[:, None] < 0, -qb, qb)
    d = jnp.abs(d)
    theta = jnp.arccos(jnp.clip(d, -1.0, 1.0))
    sin_t = jnp.sin(theta)
    w0 = jnp.where(sin_t > 1e-6, jnp.sin((1 - frac) * theta) / jnp.maximum(sin_t, 1e-12), 1 - frac)
    w1 = jnp.where(sin_t > 1e-6, jnp.sin(frac * theta) / jnp.maximum(sin_t, 1e-12), frac)
    q = w0[:, None] * qa + w1[:, None] * qb
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    R = jax.vmap(tfm.matrix_from_quat)(q)
    trans = (1 - frac)[:, None] * trans_w[i0] + frac[:, None] * trans_w[i0 + 1]
    # Into the end-of-scan frame like the reference: p' = T_end^-1 T(t) p
    # with T_end = pose_lookup(t_last) (impl/deskew_impl.hpp:106-117).
    T_end = jnp.asarray(poses[-1], jnp.float32)
    R_end_inv = T_end[:3, :3].T
    world = jnp.einsum("nij,nj->ni", R, cloud.xyz, precision=tfm.HIGHEST)
    world = world + trans
    xyz = jnp.matmul(
        world - T_end[:3, 3], R_end_inv.T, precision=tfm.HIGHEST
    )
    out = dataclasses.replace(cloud, xyz=xyz)
    # Normals rotate with the per-point relative motion, like ``deskew``
    # (transformCloud rotates normals, core/transform.hpp:42-82).
    if "normal" in cloud.channels:
        nrm = cloud.channels["normal"]
        n3 = jnp.einsum(
            "ij,njk,nk->ni", R_end_inv, R, nrm[:, :3], precision=tfm.HIGHEST
        )
        out = out.with_channel(
            "normal", nrm.at[:, :3].set(n3) if nrm.shape[1] == 4 else n3
        )
    return out


# ---------------------------------------------------------------------------
# Outlier removal (nanoPCL filters/impl/outlier_removal_impl.hpp)
# ---------------------------------------------------------------------------


def statistical_outlier_removal(
    cloud: PointCloud,
    k: int = 20,
    std_mul: float = 1.0,
    method: str = "auto",
    bucket_size: Optional[float] = None,
) -> PointCloud:
    """Remove points whose mean kNN distance exceeds
    global_mean + std_mul * global_std (outlier_removal_impl.hpp:83-141;
    population std over all points, threshold inclusive <=).

    Masked points are excluded from both the statistics and the output.
    """
    from fastdem_tpu.cloud import search

    n = cloud.capacity
    _, dist = search.knn(
        cloud.xyz, cloud.mask, k, method=method, bucket_size=bucket_size
    )
    valid_nb = jnp.isfinite(dist)
    cnt = jnp.sum(valid_nb, axis=1)
    mean_d = jnp.where(
        cnt > 0,
        jnp.sum(jnp.where(valid_nb, dist, 0.0), axis=1) / jnp.maximum(cnt, 1),
        0.0,
    )
    m = cloud.mask
    nvalid = jnp.maximum(jnp.sum(m), 1)
    g_mean = jnp.sum(jnp.where(m, mean_d, 0.0)) / nvalid
    g_var = jnp.sum(jnp.where(m, (mean_d - g_mean) ** 2, 0.0)) / nvalid
    threshold = g_mean + std_mul * jnp.sqrt(g_var)
    return cloud.with_mask(m & (mean_d <= threshold))


def radius_outlier_removal(
    cloud: PointCloud,
    radius: float,
    min_neighbors: int = 2,
    method: str = "auto",
    per_bucket: int = 16,
) -> PointCloud:
    """Keep points with >= min_neighbors other points within ``radius``
    (outlier_removal_impl.hpp:21-48). "auto"/"brute" counts exactly at
    any N via the tiled direct-difference pass (the count needs no
    candidate extraction; which of it and the dense-table grid is faster
    on the GPU is not measured); "grid" opts into search.radius_search_grid (exact,
    returns the neighbor sets too); "bucket" keeps the capped
    approximate voxel-bucket count for latency-bound callers."""
    if method in ("auto", "brute"):
        from fastdem_tpu.cloud.search import radius_count_brute

        cnt = radius_count_brute(cloud.xyz, cloud.mask, radius)
    elif method == "grid":
        from fastdem_tpu.cloud.search import radius_search_grid

        _, _, cnt = radius_search_grid(cloud.xyz, cloud.mask, radius, 1)
    else:
        from fastdem_tpu.cloud.search import BucketGrid

        grid = BucketGrid(cloud.xyz, cloud.mask, radius)
        cnt = grid.radius_count(
            cloud.xyz,
            radius,
            per_bucket=per_bucket,
            exclude_self_idx=jnp.arange(cloud.capacity, dtype=jnp.int32),
        )
    return cloud.with_mask(cloud.mask & (cnt >= min_neighbors))
