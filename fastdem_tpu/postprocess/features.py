"""PCA terrain-feature extraction: step, slope, roughness, curvature, normals.

Equivalent of applyFeatureExtraction
(/root/reference/fastdem/src/feature_extraction.cpp:28-118): per cell, local
PCA over the disk neighborhood of world-frame displacements
d = (-dr*res, -dc*res, z_n - z_c) (grid row -> -x, col -> -y, :75-77), then
  step      = percentile z-range over the window (:103-106)
  slope     = acos(|n_z|) in degrees (:108-109)
  roughness = sqrt(lambda_0)  (smallest eigenvalue)
  curvature = |lambda_0 / trace| (trace > 0 else 0)
  normal    = smallest eigenvector, flipped upward (:98-100)
with the reference guards: center finite, >= min_valid neighbors, PCA valid
(trace >= f32 eps), lambda_1 >= 1e-8 (:85-96). Skipped cells keep their
previous layer values.

Shape of the computation: the windowed moment sums are contractions of the [K, H, W]
shifted stack against constant per-offset vectors; the eigen-solve is the
closed-form batched 3x3 (cloud/pca.py). Everything is one fused pass, no
per-cell loops.
"""

from __future__ import annotations

from typing import Dict

import jax.numpy as jnp
import numpy as np

from fastdem_tpu.cloud.pca import compute_pca
from fastdem_tpu.cloud.transform import HIGHEST
from fastdem_tpu.config.config import FeatureExtractionConfig
from fastdem_tpu.postprocess.stencil import disk_offsets, window_stack

_MIN_EIGENVALUE = 1e-8  # feature_extraction.cpp:93


def extract_features(
    elevation: jnp.ndarray,
    cfg: FeatureExtractionConfig,
    resolution: float,
) -> Dict[str, jnp.ndarray]:
    """Returns dict with step/slope/roughness/curvature/normal_{x,y,z} and
    'ok' (the update mask)."""
    offsets = disk_offsets(cfg.analysis_radius, resolution)
    K = len(offsets)
    off = np.asarray(offsets, dtype=np.float32)
    dx = jnp.asarray(-off[:, 0] * resolution)  # [K] (row -> -x)
    dy = jnp.asarray(-off[:, 1] * resolution)  # [K] (col -> -y)

    win = window_stack(elevation, offsets)  # [K, H, W]
    finite = jnp.isfinite(win)
    f = finite.astype(jnp.float32)
    dz = jnp.where(finite, win - elevation[None], 0.0)  # [K, H, W]

    n = jnp.sum(f, axis=0)  # valid neighbor count
    n_safe = jnp.maximum(n, 1.0)

    # Moment sums over the window (constants contract against f / dz).
    sx = jnp.einsum("k,khw->hw", dx, f, precision=HIGHEST)
    sy = jnp.einsum("k,khw->hw", dy, f, precision=HIGHEST)
    sz = jnp.sum(dz, axis=0)
    sxx = jnp.einsum("k,khw->hw", dx * dx, f, precision=HIGHEST)
    syy = jnp.einsum("k,khw->hw", dy * dy, f, precision=HIGHEST)
    sxy = jnp.einsum("k,khw->hw", dx * dy, f, precision=HIGHEST)
    sxz = jnp.einsum("k,khw->hw", dx, dz, precision=HIGHEST)
    syz = jnp.einsum("k,khw->hw", dy, dz, precision=HIGHEST)
    szz = jnp.sum(dz * dz, axis=0)

    mx, my, mz = sx / n_safe, sy / n_safe, sz / n_safe
    cxx = sxx / n_safe - mx * mx
    cyy = syy / n_safe - my * my
    czz = szz / n_safe - mz * mz
    cxy = sxy / n_safe - mx * my
    cxz = sxz / n_safe - mx * mz
    cyz = syz / n_safe - my * mz

    cov = jnp.stack(
        [
            jnp.stack([cxx, cxy, cxz], axis=-1),
            jnp.stack([cxy, cyy, cyz], axis=-1),
            jnp.stack([cxz, cyz, czz], axis=-1),
        ],
        axis=-2,
    )  # [H, W, 3, 3]

    pca = compute_pca(cov)
    lam = pca.eigenvalues  # [H, W, 3] ascending
    normal = pca.eigenvectors[..., :, 0]  # smallest eigenvector
    normal = jnp.where(normal[..., 2:3] < 0.0, -normal, normal)

    # Step: percentile range of sorted window z values (:103-106).
    zs = jnp.sort(jnp.where(finite, win, jnp.inf), axis=0)  # [K, H, W]
    lo_i = (cfg.step_lower_percentile * (n - 1.0)).astype(jnp.int32)
    hi_i = (cfg.step_upper_percentile * (n - 1.0)).astype(jnp.int32)
    lo_i = jnp.clip(lo_i, 0, K - 1)
    hi_i = jnp.clip(hi_i, 0, K - 1)
    z_lo = jnp.take_along_axis(zs, lo_i[None], axis=0)[0]
    z_hi = jnp.take_along_axis(zs, hi_i[None], axis=0)[0]
    step = z_hi - z_lo

    trace = cxx + cyy + czz
    slope = jnp.degrees(jnp.arccos(jnp.clip(jnp.abs(normal[..., 2]), 0.0, 1.0)))
    roughness = jnp.sqrt(jnp.maximum(lam[..., 0], 0.0))
    curvature = jnp.where(trace > 0.0, jnp.abs(lam[..., 0] / trace), 0.0)

    ok = (
        jnp.isfinite(elevation)
        & (n >= cfg.min_valid_neighbors)
        & pca.valid
        & (lam[..., 1] >= _MIN_EIGENVALUE)
    )
    return {
        "step": step,
        "slope": slope,
        "roughness": roughness,
        "curvature": curvature,
        "normal_x": normal[..., 0],
        "normal_y": normal[..., 1],
        "normal_z": normal[..., 2],
        "ok": ok,
    }


def apply_feature_extraction(geom, state, cfg: FeatureExtractionConfig):
    from fastdem_tpu.grid.gridmap import layers

    if not cfg.enabled:
        return state
    feats = extract_features(
        state.layers[layers.elevation], cfg, geom.resolution
    )
    ok = feats.pop("ok")
    name_map = {
        "step": layers.step,
        "slope": layers.slope,
        "roughness": layers.roughness,
        "curvature": layers.curvature,
        "normal_x": layers.normal_x,
        "normal_y": layers.normal_y,
        "normal_z": layers.normal_z,
    }
    updates = {}
    for key, lname in name_map.items():
        prev = state.layers.get(lname, jnp.full(geom.shape, jnp.nan))
        updates[lname] = jnp.where(ok, feats[key], prev)
    return state.replace_layers(updates)
