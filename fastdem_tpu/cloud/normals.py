"""Normal and covariance estimation from local neighborhoods.

Equivalent of nanoPCL's normal/covariance estimation
(/root/reference/fastdem/lib/nanoPCL/include/nanopcl/geometry/
normal_estimation.hpp:43-284, incl. the OMP variants — parallelism is
implicit here): per point, PCA over the kNN neighborhood; the normal is the
smallest eigenvector, oriented toward the viewpoint (default origin, the
reference's convention); covariances (for GICP) are the full neighborhood
covariance matrices.

Batched formulation: one kNN query (cloud/search.py), gathered neighbor
coordinates [N, k, 3], moment sums, then the closed-form batched 3x3
eigendecomposition (cloud/pca.py).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from fastdem_tpu.cloud.pca import eigh3x3
from fastdem_tpu.cloud.pointcloud import PointCloud
from fastdem_tpu.cloud.search import knn
from fastdem_tpu.cloud.transform import HIGHEST


def _neighborhood_cov(
    xyz: jnp.ndarray, idx: jnp.ndarray, include_self: bool = True
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-point covariance over gathered neighbors. Returns (cov, count)."""
    valid = idx >= 0
    pts = xyz[jnp.maximum(idx, 0)]  # [N, k, 3]
    if include_self:
        pts = jnp.concatenate([xyz[:, None, :], pts], axis=1)
        valid = jnp.concatenate(
            [jnp.ones((xyz.shape[0], 1), bool), valid], axis=1
        )
    w = valid.astype(jnp.float32)[..., None]
    cnt = jnp.sum(w[..., 0], axis=1)
    cnt_safe = jnp.maximum(cnt, 1.0)[:, None]
    mean = jnp.sum(pts * w, axis=1) / cnt_safe
    d = (pts - mean[:, None, :]) * w
    cov = jnp.einsum("nki,nkj->nij", d, d, precision=HIGHEST)
    cov = cov / cnt_safe[..., None]
    return cov, cnt


@jax.jit
def _normals_tail(xyz: jnp.ndarray, idx: jnp.ndarray, vp: jnp.ndarray):
    """Post-kNN normal computation as ONE program (the eager op-by-op
    form pays a per-op dispatch through a remote-device link)."""
    cov, cnt = _neighborhood_cov(xyz, idx)
    lam, vec = eigh3x3(cov)
    normal = vec[..., 0]  # smallest eigenvector
    to_vp = vp[None, :] - xyz
    flip = jnp.sum(normal * to_vp, axis=-1) < 0.0
    normal = jnp.where(flip[:, None], -normal, normal)
    # Degenerate neighborhoods (fewer than 3 points) -> zero normal.
    ok = (cnt >= 3.0) & (lam[..., 2] > 1e-12)
    return jnp.where(ok[:, None], normal, 0.0)


def _grid_eligible(cloud, method):
    from fastdem_tpu.cloud import search as _s

    if method == "grid":
        return True
    if method != "auto":
        return False
    concrete = not (
        isinstance(cloud.xyz, jax.core.Tracer)
        or isinstance(cloud.mask, jax.core.Tracer)
    )
    return concrete and cloud.xyz.shape[0] >= _s._GRID_CROSSOVER


def estimate_normals(
    cloud: PointCloud,
    k: int = 10,
    viewpoint=(0.0, 0.0, 0.0),
    method: str = "auto",
    bucket_size: Optional[float] = None,
) -> PointCloud:
    """Adds a 'normal' channel; normals oriented toward ``viewpoint``.

    On the grid path the PCA tail is FUSED into the kNN table pass (one
    device dispatch for the whole estimate; search.knn_grid tail)."""
    vp = jnp.asarray(viewpoint, dtype=jnp.float32)
    if _grid_eligible(cloud, method):
        from fastdem_tpu.cloud.search import knn_grid

        _, _, normal = knn_grid(
            cloud.xyz, cloud.mask, k, bucket_size=bucket_size,
            tail=_normals_tail, tail_args=(vp,),
        )
        return cloud.with_channel("normal", normal)
    idx, _ = knn(cloud.xyz, cloud.mask, k, method=method, bucket_size=bucket_size)
    normal = _normals_tail(cloud.xyz, idx, vp)
    return cloud.with_channel("normal", normal)


@functools.partial(jax.jit, static_argnames=("regularize",))
def _cov_tail(
    xyz: jnp.ndarray, idx: jnp.ndarray, epsilon, regularize: bool
):
    cov, cnt = _neighborhood_cov(xyz, idx)
    if regularize:
        lam, vec = eigh3x3(cov)
        # Replace eigenvalues by (eps, 1, 1) in ascending-order slots.
        new_lam = jnp.stack(
            [
                jnp.full(lam.shape[:-1], epsilon, dtype=cov.dtype),
                jnp.ones(lam.shape[:-1], dtype=cov.dtype),
                jnp.ones(lam.shape[:-1], dtype=cov.dtype),
            ],
            axis=-1,
        )
        cov = jnp.einsum(
            "...ik,...k,...jk->...ij", vec, new_lam, vec, precision=HIGHEST
        )
    ok = cnt >= 3.0
    eye = jnp.eye(3, dtype=cov.dtype)
    return jnp.where(ok[:, None, None], cov, eye)


def _cov_tail_reg(xyz, idx, epsilon):
    """Fixed-arity tail forms for knn_grid fusion (the jit-cache key is
    the function object, so these must be stable module-level symbols)."""
    return _cov_tail(xyz, idx, epsilon, True)


def _cov_tail_noreg(xyz, idx, epsilon):
    return _cov_tail(xyz, idx, epsilon, False)


def estimate_covariances(
    cloud: PointCloud,
    k: int = 10,
    regularize: bool = True,
    epsilon: float = 1e-3,
    method: str = "auto",
    bucket_size: Optional[float] = None,
) -> PointCloud:
    """Adds a 'covariance' channel [N, 3, 3] (GICP-style). With
    ``regularize``, eigenvalues are flattened to (eps, 1, 1) along the
    principal axes — the standard plane-to-plane regularization. On the
    grid path the PCA tail is fused into the kNN pass (one dispatch)."""
    eps = jnp.float32(epsilon)
    if _grid_eligible(cloud, method):
        from fastdem_tpu.cloud.search import knn_grid

        tail = _cov_tail_reg if regularize else _cov_tail_noreg
        _, _, cov = knn_grid(
            cloud.xyz, cloud.mask, k, bucket_size=bucket_size,
            tail=tail, tail_args=(eps,),
        )
        return cloud.with_channel("covariance", cov)
    idx, _ = knn(cloud.xyz, cloud.mask, k, method=method, bucket_size=bucket_size)
    cov = _cov_tail(cloud.xyz, idx, eps, regularize)
    return cloud.with_channel("covariance", cov)
