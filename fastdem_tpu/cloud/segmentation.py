"""Segmentation: RANSAC plane fit, euclidean clustering, ground extraction.

Vectorized equivalents of nanoPCL's segmentation module
(/root/reference/fastdem/lib/nanoPCL/include/nanopcl/segmentation/):
  * RANSAC plane (ransac_plane.hpp:126-157): all hypothesis triples are
    drawn up-front and scored in one batched [M, N] distance pass (the
    reference parallelizes inlier counting with OpenMP; here the whole
    hypothesis sweep is a single fused vector computation), then refined
    by PCA over the inliers.
  * Euclidean clustering (euclidean_cluster.hpp:171-202): iterative
    min-label propagation over the voxel-bucket neighbor graph (the
    pointer-jumping equivalent of the reference's BFS region growing).
  * Grid ground segmentation (ground_seg.hpp:91-103 +
    impl/ground_seg_impl.hpp:51-107): per-cell robust minimum as the exact
    percentile order statistic via sort-by-(cell, z) and a per-point
    head-offset gather, then the thickness-band classification.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from fastdem_tpu.cloud.pointcloud import PointCloud
from fastdem_tpu.cloud.search import BucketGrid


# ---------------------------------------------------------------------------
# RANSAC plane
# ---------------------------------------------------------------------------


class PlaneModel(NamedTuple):
    coefficients: jnp.ndarray  # [nx, ny, nz, d], |n| = 1, n.p + d = 0


@dataclasses.dataclass
class RansacResult:
    model: PlaneModel
    inliers: jnp.ndarray  # bool[N]
    fitness: float
    iterations: int

    def success(self) -> bool:
        return self.fitness > 0.0


def segment_plane(
    cloud: PointCloud,
    distance_threshold: float = 0.1,
    max_iterations: int = 100,
    seed: int = 0,
    refine: bool = True,
) -> RansacResult:
    """RANSAC plane fit; one batched hypothesis sweep."""
    n = cloud.capacity
    key = jax.random.PRNGKey(seed)
    # Sample 3 distinct-ish indices per hypothesis; degenerate triples
    # score ~0 inliers and lose naturally.
    idx = jax.random.randint(key, (max_iterations, 3), 0, n)
    p = cloud.xyz[idx]  # [M, 3, 3]
    v1 = p[:, 1] - p[:, 0]
    v2 = p[:, 2] - p[:, 0]
    normal = jnp.cross(v1, v2)
    norm = jnp.linalg.norm(normal, axis=1, keepdims=True)
    ok = (norm[:, 0] > 1e-8) & jnp.all(cloud.mask[idx], axis=1)
    normal = normal / jnp.maximum(norm, 1e-12)
    d = -jnp.sum(normal * p[:, 0], axis=1)  # [M]

    # [M, N] point-plane distances in one matmul.
    dist = jnp.abs(cloud.xyz @ normal.T + d[None, :]).T
    inl = (dist <= distance_threshold) & cloud.mask[None, :]
    counts = jnp.where(ok, jnp.sum(inl, axis=1), -1)
    best = jnp.argmax(counts)
    best_normal = normal[best]
    best_d = d[best]
    inliers = inl[best]

    if refine:
        # PCA refinement over the inliers (weighted moments).
        w = inliers.astype(jnp.float32)
        cnt = jnp.maximum(jnp.sum(w), 1.0)
        mean = jnp.sum(cloud.xyz * w[:, None], axis=0) / cnt
        dd = (cloud.xyz - mean) * w[:, None]
        cov = dd.T @ dd / cnt
        from fastdem_tpu.cloud.pca import eigh3x3

        lam, vec = eigh3x3(cov[None])
        nrm = vec[0, :, 0]
        nrm = jnp.where(best_normal @ nrm < 0, -nrm, nrm)
        best_normal = nrm
        best_d = -nrm @ mean
        dist1 = jnp.abs(cloud.xyz @ best_normal + best_d)
        inliers = (dist1 <= distance_threshold) & cloud.mask

    fitness = float(jnp.sum(inliers)) / max(int(jnp.sum(cloud.mask)), 1)
    return RansacResult(
        model=PlaneModel(jnp.concatenate([best_normal, best_d[None]])),
        inliers=inliers,
        fitness=fitness,
        iterations=max_iterations,
    )


# ---------------------------------------------------------------------------
# Euclidean clustering
# ---------------------------------------------------------------------------


def euclidean_cluster(
    cloud: PointCloud,
    tolerance: float = 0.5,
    min_cluster_size: int = 1,
    max_cluster_size: Optional[int] = None,
    per_bucket: int = 16,
    max_sweeps: int = 64,
) -> jnp.ndarray:
    """Connected components of the radius-``tolerance`` graph.

    Returns i32[N] labels (compacted, -1 for invalid / filtered points).
    Implementation: min-label propagation with pointer jumping (label =
    label[label]) until a fixpoint — log-diameter sweeps of dense gathers
    instead of the reference's sequential BFS.
    """
    n = cloud.capacity
    grid = BucketGrid(cloud.xyz, cloud.mask, tolerance)
    cand, cvalid = grid.candidates(cloud.xyz, per_bucket)
    cpts = cloud.xyz[jnp.maximum(cand, 0)]
    d2 = jnp.sum((cpts - cloud.xyz[:, None, :]) ** 2, axis=-1)
    adj = cvalid & (d2 <= tolerance * tolerance)
    adj = adj & cloud.mask[:, None]
    cand = jnp.where(adj, cand, n)

    labels0 = jnp.where(cloud.mask, jnp.arange(n, dtype=jnp.int32), n)

    def body(state):
        labels, _, i = state
        lab_ext = jnp.concatenate([labels, jnp.array([n], jnp.int32)])
        neigh = lab_ext[cand]  # [N, K]
        new = jnp.minimum(labels, jnp.min(neigh, axis=1))
        # Pointer jumping accelerates convergence.
        new = jnp.minimum(new, lab_ext[jnp.minimum(new, n - 1)])
        changed = jnp.any(new != labels)
        return new, changed, i + 1

    def cond(state):
        _, changed, i = state
        return changed & (i < max_sweeps)

    labels, _, _ = jax.lax.while_loop(
        cond, body, (labels0, jnp.bool_(True), jnp.int32(0))
    )

    # Compact labels + size filtering.
    valid = cloud.mask
    root = valid & (labels == jnp.arange(n))
    compact = jnp.cumsum(root.astype(jnp.int32)) - 1
    lab_compact = jnp.where(
        valid, compact[jnp.clip(labels, 0, n - 1)], -1
    )
    sizes = (
        jnp.zeros(n + 1, dtype=jnp.int32)
        .at[jnp.where(valid, lab_compact, n)]
        .add(1)
    )
    sz = sizes[jnp.clip(lab_compact, 0, n - 1)]
    keep = valid & (sz >= min_cluster_size)
    if max_cluster_size is not None:
        keep = keep & (sz <= max_cluster_size)
    return jnp.where(keep, lab_compact, -1)


# ---------------------------------------------------------------------------
# Grid ground segmentation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GroundSegConfig:
    """Mirrors nanopcl GroundSegConfig (ground_seg.hpp:34-40)."""

    grid_resolution: float = 0.5
    cell_percentile: float = 0.2
    ground_thickness: float = 0.3
    max_ground_height: float = 0.5
    min_points_per_cell: int = 2


def segment_ground(
    cloud: PointCloud, config: Optional[GroundSegConfig] = None
) -> jnp.ndarray:
    """Grid-based ground mask, exact reference semantics
    (impl/ground_seg_impl.hpp:51-107):
      * per 2D cell, robust_min = the floor(percentile * (count-1))-th
        sorted z (exact order statistic via sort-by-(cell, z) + per-point
        head-offset gather)
      * ground = z <= robust_min + ground_thickness (no lower bound)
      * obstacle-only cell when robust_min > max_ground_height (absolute)
        or the cell has < min_points_per_cell points.
    Returns bool[N] ground mask.
    """
    cfg = config or GroundSegConfig()
    n = cloud.capacity
    res = cfg.grid_resolution
    coords = jnp.floor(cloud.xyz[:, :2] / res).astype(jnp.int32)
    B = 4096
    cell = (
        jnp.clip(coords[:, 0] + B // 2, 0, B - 1) * B
        + jnp.clip(coords[:, 1] + B // 2, 0, B - 1)
    )
    cell = jnp.where(cloud.mask, cell, jnp.int32(2**31 - 1))

    from fastdem_tpu.ops import segments as seg

    cell_s, z_s, idx_s = jax.lax.sort(
        (cell, cloud.xyz[:, 2], jnp.arange(n, dtype=jnp.int32)), num_keys=2
    )
    valid_s = cell_s != jnp.int32(2**31 - 1)
    heads = seg.segment_heads(cell_s, valid_s)
    gid = jnp.cumsum(heads.astype(jnp.int32)) - 1
    gid = jnp.where(valid_s, gid, n)
    cnt = jax.ops.segment_sum(
        valid_s.astype(jnp.int32), gid, num_segments=n + 1
    )
    cnt_s = cnt[jnp.minimum(gid, n)]
    # Per-point position of its cell's head (forward segmented min of the
    # position index), then the exact percentile order statistic.
    pos = jnp.arange(n, dtype=jnp.int32)
    head_pos = seg.segmented_scan(jnp.minimum, pos, heads)
    k = jnp.floor(
        cfg.cell_percentile * jnp.maximum(cnt_s - 1, 0).astype(jnp.float32)
    ).astype(jnp.int32)
    robust_pos = jnp.clip(head_pos + k, 0, n - 1)
    robust_min = z_s[robust_pos]

    ground_s = (
        valid_s
        & (cnt_s >= cfg.min_points_per_cell)
        & (robust_min <= cfg.max_ground_height)
        & (z_s <= robust_min + cfg.ground_thickness)
    )
    ground = jnp.zeros(n, dtype=bool).at[idx_s].set(ground_s)
    return ground & cloud.mask
