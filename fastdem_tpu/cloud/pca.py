"""Batched closed-form symmetric 3x3 eigendecomposition.

Vectorized equivalent of nanopcl::geometry::computePCA
(/root/reference/fastdem/lib/nanoPCL/include/nanopcl/geometry/impl/pca.hpp:67-88):
analytic eigenvalues (trigonometric method) + cross-product eigenvectors,
fully vectorized over arbitrary leading batch dimensions — no iterative
solver, no data-dependent control flow.

Conventions match Eigen's SelfAdjointEigenSolver as used by the reference:
eigenvalues ascending (smallest first = surface-normal direction);
``valid`` is False for degenerate covariances (trace < f32 epsilon).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

_EPS = 1.1920929e-07  # float32 machine epsilon (pca.hpp:71)


class PCAResult(NamedTuple):
    eigenvalues: jnp.ndarray  # [..., 3] ascending
    eigenvectors: jnp.ndarray  # [..., 3, 3] columns are eigenvectors
    valid: jnp.ndarray  # [...] bool


def eigh3x3(A: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Eigenvalues (ascending) and eigenvectors of symmetric [..., 3, 3]."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 0.0))
    near_diag = p < 1e-12

    p_safe = jnp.where(near_diag, 1.0, p)
    c00, c11, c22 = b00 / p_safe, b11 / p_safe, b22 / p_safe
    c01, c02, c12 = a01 / p_safe, a02 / p_safe, a12 / p_safe
    detB = (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0

    lam_max = q + 2.0 * p * jnp.cos(phi)
    lam_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min

    diag_sorted = jnp.sort(jnp.stack([a00, a11, a22], axis=-1), axis=-1)
    lams = jnp.stack([lam_min, lam_mid, lam_max], axis=-1)
    lams = jnp.where(near_diag[..., None], diag_sorted, lams)

    vecs = jnp.stack(
        [_eigvec(A, lams[..., k]) for k in range(3)], axis=-1
    )
    return lams, vecs


def _eigvec(A: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """Eigenvector of symmetric A for eigenvalue lam: the largest cross
    product of rows of (A - lam I) spans the null-space complement."""
    B = A - lam[..., None, None] * jnp.eye(3, dtype=A.dtype)
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    norms = jnp.stack([n01, n02, n12], axis=-1)
    best = jnp.argmax(norms, axis=-1)
    cand = jnp.stack([c01, c02, c12], axis=-2)  # [..., 3 candidates, 3]
    v = jnp.take_along_axis(
        cand, best[..., None, None].astype(jnp.int32), axis=-2
    )[..., 0, :]
    norm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    # Degenerate (repeated eigenvalue): fall back to e_z.
    fallback = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 1.0], dtype=A.dtype), v.shape
    )
    return jnp.where(norm > 1e-20, v / jnp.maximum(norm, 1e-20), fallback)


def compute_pca(cov: jnp.ndarray) -> PCAResult:
    """PCA of batched covariance matrices with the reference degenerate
    guard (trace < f32 eps -> invalid, pca.hpp:70-73)."""
    trace = cov[..., 0, 0] + cov[..., 1, 1] + cov[..., 2, 2]
    valid = trace >= _EPS
    lams, vecs = eigh3x3(cov)
    return PCAResult(eigenvalues=lams, eigenvectors=vecs, valid=valid)
