"""Point-cloud registration: ICP, point-to-plane, GICP, VGICP.

Vectorized equivalent of nanoPCL's registration stack
(/root/reference/fastdem/lib/nanoPCL/include/nanopcl/registration/
align.hpp:71-337 and the factor/correspondence/optimizer headers):
Gauss-Newton over se(3) with per-iteration nearest-neighbor
correspondences, optional robust kernels (Huber / Cauchy / Tukey), and
max-correspondence-distance gating.

Shape of the computation: correspondences are one dense [Ns, Nt]
distance tile per iteration (Gram-matrix form via search.knn_brute) or a
voxel-table
lookup (VGICP); the 6x6 normal equations are einsum reductions over all
correspondences; each GN step is a tiny solve. The whole ``align`` runs
as a host-controlled loop of jitted iterations with early convergence
exit.

Variants:
  * ``icp``            point-to-point, e = R s + t - q
  * ``point_to_plane`` e = n_q . (R s + t - q); needs target normals
  * ``gicp``           plane-to-plane Mahalanobis with per-point
                       covariances Omega = (C_q + R C_s R^T)^-1
  * ``vgicp``          GICP against per-voxel target Gaussian
                       distributions; correspondence = the voxel
                       CONTAINING the transformed point (reference
                       voxel_correspondence.hpp:61 lookupRegularized),
                       found by searchsorted over the sorted voxel keys,
                       with Segal-style covariance regularization
                       (eigenvalues -> [eps, 1, 1],
                       voxel_distribution_map.hpp regularizeCovariance).

Optimizers: ``gn`` (Gauss-Newton, fixed tiny damping) and ``lm``
(Levenberg-Marquardt with the reference's adaptive lambda schedule,
optimizers/lm_optimizer.hpp:52-85 — inner accept/reject loop, lambda /=
10 on improvement, *= 10 on failure).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fastdem_tpu.cloud import transform as tfm
from fastdem_tpu.cloud.pointcloud import PointCloud


@dataclasses.dataclass
class RegistrationResult:
    T: np.ndarray  # final source->target transform
    converged: bool
    iterations: int
    error: float
    num_correspondences: int


def _robust_weight(kernel: str, scale: float, r2: jnp.ndarray) -> jnp.ndarray:
    """IRLS weights from squared residual norms."""
    r = jnp.sqrt(jnp.maximum(r2, 1e-20))
    if kernel == "none":
        return jnp.ones_like(r)
    if kernel == "huber":
        return jnp.where(r <= scale, 1.0, scale / r)
    if kernel == "cauchy":
        return 1.0 / (1.0 + (r / scale) ** 2)
    if kernel == "tukey":
        w = (1.0 - (r / scale) ** 2) ** 2
        return jnp.where(r <= scale, w, 0.0)
    raise ValueError(f"unknown robust kernel '{kernel}'")


def _solve_gn(H: jnp.ndarray, g: jnp.ndarray, damping: float = 1e-6):
    H = H + damping * jnp.eye(6, dtype=H.dtype)
    return jnp.linalg.solve(H, -g)


def _skew_batch(v: jnp.ndarray) -> jnp.ndarray:
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([z, -v[..., 2], v[..., 1]], axis=-1),
            jnp.stack([v[..., 2], z, -v[..., 0]], axis=-1),
            jnp.stack([-v[..., 1], v[..., 0], z], axis=-1),
        ],
        axis=-2,
    )


def _inv3x3(M: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), b * f - c * e], axis=-1),
            jnp.stack([B, a * i - c * g, -(a * f - c * d)], axis=-1),
            jnp.stack([C, -(a * h - b * g), a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def _nearest(source_T: jnp.ndarray, target: jnp.ndarray, target_mask):
    """1-NN via the Gram tile. Returns (idx, dist2)."""
    d2 = (
        jnp.sum(source_T * source_T, axis=1)[:, None]
        + jnp.sum(target * target, axis=1)[None, :]
        - 2.0 * jnp.matmul(source_T, target.T, precision=tfm.HIGHEST)
    )
    d2 = jnp.where(target_mask[None, :], d2, jnp.inf)
    idx = jnp.argmin(d2, axis=1)
    return idx, jnp.take_along_axis(d2, idx[:, None], axis=1)[:, 0]


def _gn_step_factory(method: str, kernel: str, kernel_scale: float,
                     max_dist: float, corr: str = "nearest",
                     voxel_size: float = 0.5,
                     corr_dims: Optional[Tuple[int, int, int]] = None):
    """Builds the jitted single iteration (linearize + damped solve) and a
    jitted error-only evaluation for a method.

    ``corr``:
      * "nearest"      dense 1-NN Gram tile;
      * "voxel"        containing-voxel searchsorted lookup against sorted
                       voxel keys (the reference VGICP correspondence,
                       voxel_correspondence.hpp:55-70; no distance gate —
                       the voxel either contains the transformed point or
                       there is no correspondence);
      * "voxel_dense"  same containing-voxel semantics against a DENSE
                       [ncells] table over the lattice-aligned bbox grid
                       (``corr_dims`` static, origin passed through the
                       vox_aux arg): the voxel id is ARITHMETIC and the
                       lookup is one row gather per field, where the
                       searchsorted form costs ~34 gathers per point per
                       pass (binary search).
    """

    def _correspond(src, s_mask, t_xyz, t_mask, vox_aux):
        if corr == "voxel_dense":
            nx, ny, nz = corr_dims
            origin = vox_aux  # f32[3], lattice-aligned
            c = jnp.floor((src - origin[None, :]) / voxel_size).astype(
                jnp.int32
            )
            inb = jnp.all((c >= 0) & (c < jnp.asarray(
                [nx, ny, nz], dtype=jnp.int32)[None, :]), axis=1)
            cc = jnp.clip(
                c, 0, jnp.asarray([nx - 1, ny - 1, nz - 1], jnp.int32)
            )
            key = (cc[:, 0] * ny + cc[:, 1]) * nz + cc[:, 2]
            valid = s_mask & inb & t_mask[key]
            return key, valid
        if corr == "voxel":
            from fastdem_tpu.cloud.filters import voxel_coords, voxel_key

            key = voxel_key(voxel_coords(src, voxel_size))
            n = vox_aux.shape[0]
            pos = jnp.clip(
                jnp.searchsorted(vox_aux, key), 0, n - 1
            ).astype(jnp.int32)
            match = vox_aux[pos] == key
            valid = s_mask & match & t_mask[pos]
            return pos, valid
        idx, d2 = _nearest(src, t_xyz, t_mask)
        valid = s_mask & (d2 <= max_dist * max_dist) & jnp.isfinite(d2)
        return idx, valid

    def linearize(T, s_xyz, s_mask, t_xyz, t_mask, t_normals, s_cov, t_cov,
                  vox_keys):
        src = tfm.transform_points(s_xyz, T)
        idx, valid = _correspond(src, s_mask, t_xyz, t_mask, vox_keys)
        q = t_xyz[idx]

        e = src - q  # [N, 3]
        R = T[:3, :3]
        if method == "icp":
            r2 = jnp.sum(e * e, axis=1)
            w = _robust_weight(kernel, kernel_scale, r2) * valid
            # J_i = [I | -skew(R s + t)] acting on (dt, dw)
            S = _skew_batch(src)
            J = jnp.concatenate(
                [jnp.broadcast_to(jnp.eye(3), (src.shape[0], 3, 3)), -S],
                axis=2,
            )  # [N, 3, 6]
            H = jnp.einsum("nij,n,nik->jk", J, w, J)
            g = jnp.einsum("nij,n,ni->j", J, w, e)
            err = jnp.sum(w * r2)
        elif method == "point_to_plane":
            n = t_normals[idx]
            r = jnp.sum(n * e, axis=1)
            r2 = r * r
            w = _robust_weight(kernel, kernel_scale, r2) * valid
            # J_i = [n^T | (src x n)^T]
            J = jnp.concatenate([n, jnp.cross(src, n)], axis=1)  # [N, 6]
            H = jnp.einsum("ni,n,nj->ij", J, w, J)
            g = jnp.einsum("ni,n,n->i", J, w, r)
            err = jnp.sum(w * r2)
        else:  # gicp / vgicp share the distribution form
            Cs = jnp.einsum("ij,njk,lk->nil", R, s_cov, R)
            Omega = _inv3x3(t_cov[idx] + Cs)  # [N, 3, 3]
            r2 = jnp.einsum("ni,nij,nj->n", e, Omega, e)
            w = _robust_weight(kernel, kernel_scale, r2) * valid
            S = _skew_batch(src)
            J = jnp.concatenate(
                [jnp.broadcast_to(jnp.eye(3), (src.shape[0], 3, 3)), -S],
                axis=2,
            )  # [N, 3, 6]
            JO = jnp.einsum("nij,nik->njk", J, Omega)  # J^T Omega -> [N,6,3]
            H = jnp.einsum("njk,nkl,n->jl", JO, J, w)
            g = jnp.einsum("njk,nk,n->j", JO, e, w)
            err = jnp.sum(w * r2)

        n_corr = jnp.sum(valid)
        err = err / jnp.maximum(n_corr, 1)
        return H, g, err, n_corr

    def step(T, lam, s_xyz, s_mask, t_xyz, t_mask, t_normals, s_cov, t_cov,
             vox_keys):
        H, g, err, n_corr = linearize(
            T, s_xyz, s_mask, t_xyz, t_mask, t_normals, s_cov, t_cov,
            vox_keys,
        )
        delta = _solve_gn(H, g, damping=lam)
        T_new = tfm.se3_exp(delta) @ T
        return T_new, delta, err, n_corr

    def err_fn(T, s_xyz, s_mask, t_xyz, t_mask, t_normals, s_cov, t_cov,
               vox_keys):
        # Error-only evaluation (LM accept/reject); XLA dead-code-
        # eliminates the H/g einsums.
        _, _, err, n_corr = linearize(
            T, s_xyz, s_mask, t_xyz, t_mask, t_normals, s_cov, t_cov,
            vox_keys,
        )
        return err, n_corr

    def solve_retract(H, g, T, lam):
        # Damped solve + retraction only — the LM inner loop linearizes
        # ONCE per outer iteration (reference lm_optimizer.hpp:52-85) and
        # re-solves per lambda trial; each trial then costs a 6x6 solve
        # plus one error evaluation instead of a second full
        # correspondence + Jacobian pass.
        delta = _solve_gn(H, g, damping=lam)
        return tfm.se3_exp(delta) @ T, delta

    # Raw (traceable) functions: the host driver jits each individually;
    # the fused driver inlines them inside one lax.while_loop program.
    return step, err_fn, linearize, solve_retract


def _build_fused_driver(
    optimizer: str,
    step,
    err_fn,
    linearize,
    solve_retract,
    max_iterations: int,
    translation_eps: float,
    rotation_eps: float,
    init_lambda: float,
    lambda_factor: float,
    max_inner_iterations: int,
    relative_error_eps: float,
    min_correspondences: int,
):
    """Whole-optimization jitted driver: the GN/LM iteration loop runs as
    ONE device program (lax.while_loop), so an align() costs one dispatch
    instead of one per iteration (the reference's host loop is free on
    CPU, lib/nanoPCL/include/nanopcl/registration/align.hpp:71-337; on an
    accelerator each dispatch and host sync costs, so this is the
    device-side equivalent, not a translation).

    Same mathematics and control flow as the host driver: GN applies the
    damped step then checks the update norms; LM linearizes once per outer
    iteration and re-solves per lambda trial, accepting only error
    decreases (lm_optimizer.hpp:52-85), declaring convergence when no
    trial improves or the accepted step is small.
    """
    teps = jnp.float32(translation_eps)
    reps = jnp.float32(rotation_eps)
    releps = jnp.float32(relative_error_eps)
    min_corr = jnp.int32(min_correspondences)

    def small(delta):
        return (jnp.linalg.norm(delta[:3]) < teps) & (
            jnp.linalg.norm(delta[3:]) < reps
        )

    def stalled(prev_err, err):
        # Reference criteria.hpp:48-52: |e_prev - e_curr| / e_prev <
        # relative_error_eps (prev initialized huge -> first rel ~ 1.0).
        return jnp.abs(prev_err - err) / jnp.maximum(prev_err, 1e-30) < releps

    if optimizer == "gn":

        @jax.jit
        def run(T, *a):
            lam = jnp.float32(1e-6)

            def cond(c):
                _, it, conv, fail, _, _, _ = c
                return (
                    (it < max_iterations)
                    & jnp.logical_not(conv)
                    & jnp.logical_not(fail)
                )

            def body(c):
                T, it, _, _, prev_err, _, _ = c
                # step() linearizes at T: err is the error AT T (pre-step),
                # matching the reference loop (iterative_solver.hpp:113-143
                # — converged() compares prev/current model errors, then
                # new_T is returned on success).
                T_new, delta, err, n_corr = step(T, lam, *a)
                n_corr = n_corr.astype(jnp.int32)
                enough = n_corr >= min_corr
                conv = (small(delta) | stalled(prev_err, err)) & enough
                # Too few correspondences -> failed result at the CURRENT
                # transform, iteration not counted
                # (iterative_solver.hpp:119-121 makeFailedResult).
                return (
                    jnp.where(enough, T_new, T),
                    it + enough.astype(jnp.int32),
                    conv,
                    jnp.logical_not(enough),
                    err, err, n_corr,
                )

            init = (T, jnp.int32(0), jnp.bool_(False), jnp.bool_(False),
                    jnp.float32(3.4e38), jnp.float32(jnp.inf), jnp.int32(0))
            T, it, conv, _fail, _, err, n_corr = jax.lax.while_loop(
                cond, body, init
            )
            return T, it, conv, err, n_corr

        return run

    @jax.jit
    def run(T, *a):
        err0, n0 = err_fn(T, *a)

        def cond(c):
            _, it, conv, fail, _, _, _ = c
            return (
                (it < max_iterations)
                & jnp.logical_not(conv)
                & jnp.logical_not(fail)
            )

        def body(c):
            T, it, _, _, err, n_corr, lam = c
            H, g, _, _ = linearize(T, *a)

            def icond(ic):
                k, accepted = ic[0], ic[1]
                return (k < max_inner_iterations) & jnp.logical_not(
                    accepted
                )

            def ibody(ic):
                k, _, lam_c, T_c, err_c, n_c, delta_c = ic
                T_try, delta = solve_retract(H, g, T, lam_c)
                err_new, n_new = err_fn(T_try, *a)
                acc = err_new < err  # vs the OUTER error, like the host
                lam_next = jnp.where(
                    acc,
                    jnp.maximum(lam_c / lambda_factor, 1e-12),
                    jnp.minimum(lam_c * lambda_factor, 1e8),
                )
                return (
                    k + 1,
                    acc,
                    lam_next,
                    jnp.where(acc, T_try, T_c),
                    jnp.where(acc, err_new, err_c),
                    jnp.where(acc, n_new.astype(jnp.int32), n_c),
                    jnp.where(acc, delta, delta_c),
                )

            iinit = (jnp.int32(0), jnp.bool_(False), lam,
                     T, err, n_corr, jnp.zeros(6, dtype=jnp.float32))
            _, accepted, lam2, T2, err2, n2, delta2 = jax.lax.while_loop(
                icond, ibody, iinit
            )
            enough = n2 >= min_corr
            # No improving trial -> local minimum (converged, state kept);
            # an accepted tiny step or a stalled error also converges
            # (criteria.hpp is_stable || is_stalled).
            conv = (
                jnp.logical_not(accepted)
                | small(delta2)
                | (accepted & stalled(err, err2))
            ) & enough
            return (T2, it + 1, conv, jnp.logical_not(enough), err2, n2,
                    lam2)

        init = (T, jnp.int32(0), jnp.bool_(False), n0 < min_corr, err0,
                n0.astype(jnp.int32), jnp.float32(init_lambda))
        T, it, conv, _fail, err, n_corr, _ = jax.lax.while_loop(
            cond, body, init
        )
        return T, it, conv, err, n_corr

    return run


@functools.lru_cache(maxsize=64)
def _step_fns_cached(method, kernel, kernel_scale, max_dist, corr,
                     voxel_size, corr_dims=None):
    """Cache the per-configuration step functions AND their jitted forms:
    building fresh jax.jit wrappers on every align() call defeats jit's
    function-identity cache, re-tracing (and without a persistent cache,
    recompiling) each call — fatal for odometry loops that align every
    frame."""
    raw = _gn_step_factory(method, kernel, kernel_scale, max_dist,
                           corr=corr, voxel_size=voxel_size,
                           corr_dims=corr_dims)
    return raw, tuple(jax.jit(f) for f in raw)


@functools.lru_cache(maxsize=64)
def _fused_driver_cached(optimizer, method, kernel, kernel_scale, max_dist,
                         corr, voxel_size, max_iterations, translation_eps,
                         rotation_eps, init_lambda, lambda_factor,
                         max_inner_iterations, relative_error_eps,
                         min_correspondences, corr_dims=None):
    raw, _ = _step_fns_cached(method, kernel, kernel_scale, max_dist, corr,
                              voxel_size, corr_dims)
    return _build_fused_driver(
        optimizer, *raw, max_iterations, translation_eps, rotation_eps,
        init_lambda, lambda_factor, max_inner_iterations,
        relative_error_eps, min_correspondences,
    )


def segal_regularize(cov: jnp.ndarray, epsilon: float = 1e-3) -> jnp.ndarray:
    """Plane-to-plane covariance regularization (Segal et al., RSS 2009):
    eigenvalues replaced by [epsilon, 1, 1] (reference
    voxel_distribution_map.hpp regularizeCovariance)."""
    w, v = jnp.linalg.eigh(cov)  # ascending eigenvalues
    w_reg = jnp.concatenate(
        [
            jnp.full(w.shape[:-1] + (1,), epsilon, dtype=cov.dtype),
            jnp.ones(w.shape[:-1] + (2,), dtype=cov.dtype),
        ],
        axis=-1,
    )
    return jnp.einsum("...ij,...j,...kj->...ik", v, w_reg, v)


def voxel_distributions(
    cloud: PointCloud, voxel_size: float
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-voxel (sorted keys, means, covariances) for VGICP targets
    (nanopcl registration/voxel_distribution_map.hpp equivalent).

    Returns (keys_sorted i32[N] with empty tail = INT32_MAX, mean f32[N,3],
    cov f32[N,3,3], valid bool[N]); entry i < num_voxels describes voxel i.
    """
    from fastdem_tpu.cloud.filters import voxel_coords, voxel_key
    from fastdem_tpu.ops import segments as seg

    n = cloud.capacity
    key = voxel_key(voxel_coords(cloud.xyz, voxel_size))
    key = jnp.where(cloud.mask, key, jnp.int32(2**31 - 1))
    key_s, x_s, y_s, z_s = jax.lax.sort(
        (key, cloud.xyz[:, 0], cloud.xyz[:, 1], cloud.xyz[:, 2]), num_keys=1
    )
    valid_s = key_s != jnp.int32(2**31 - 1)
    heads = seg.segment_heads(key_s, valid_s)
    gid = jnp.cumsum(heads.astype(jnp.int32)) - 1
    gid = jnp.where(valid_s, gid, n)
    ones = valid_s.astype(jnp.float32)
    cnt = jax.ops.segment_sum(ones, gid, num_segments=n + 1)[:n]
    pts = jnp.stack([x_s, y_s, z_s], axis=1)
    sums = jax.ops.segment_sum(pts * ones[:, None], gid, num_segments=n + 1)[:n]
    mean = sums / jnp.maximum(cnt, 1.0)[:, None]
    d = pts - mean[jnp.minimum(gid, n - 1)]
    d = d * ones[:, None]
    outer = jnp.einsum("ni,nj->nij", d, d)
    covs = jax.ops.segment_sum(outer, gid, num_segments=n + 1)[:n]
    cov = covs / jnp.maximum(cnt, 1.0)[:, None, None]
    # Regularize sparse voxels toward isotropic.
    eye = jnp.eye(3, dtype=jnp.float32)
    cov = jnp.where(
        (cnt >= 3.0)[:, None, None], cov + 1e-6 * eye, eye * voxel_size**2
    )
    # Voxel i's key is the i-th head's key (key_s sorted => heads in gid
    # order); sorting the head-masked keys compacts them to the front.
    head_keys = jnp.where(heads, key_s, jnp.int32(2**31 - 1))
    (head_keys_sorted,) = jax.lax.sort((head_keys,), num_keys=1)
    num_voxels = jnp.sum(heads)
    valid_voxel = jnp.arange(n) < num_voxels
    mean = jnp.where(valid_voxel[:, None], mean, 0.0)
    return head_keys_sorted, mean, cov, valid_voxel


def voxel_distribution_table(
    cloud: PointCloud, voxel_size: float, max_cells: int = 4_000_000
):
    """DENSE per-voxel Gaussian table for VGICP targets (r5).

    Host-computed lattice-ALIGNED bbox geometry (origin = a multiple of
    ``voxel_size``, so the partition is identical to the global voxel
    lattice the sorted form uses), then one segment-sum pass builds mean
    and covariance per cell — no sort, no searchsorted: correspondence
    becomes arithmetic cell ids + one row gather per field per iteration
    (vs ~34 binary-search gathers per point).

    Returns (origin np.f32[3], dims (nx,ny,nz), mean f32[ncells,3],
    cov f32[ncells,3,3], valid bool[ncells]).
    """
    import numpy as np

    pts = np.asarray(cloud.xyz)[np.asarray(cloud.mask)]
    if pts.shape[0] == 0:
        pts = np.zeros((1, 3), np.float32)
    b = float(voxel_size)
    lo = np.floor(pts.min(axis=0) / b) - 1
    hi = np.floor(pts.max(axis=0) / b) + 1
    while True:
        dims = (hi - lo + 1).astype(np.int64)
        if int(dims.prod()) <= max_cells:
            break
        b *= 1.5
        lo = np.floor(pts.min(axis=0) / b) - 1
        hi = np.floor(pts.max(axis=0) / b) + 1
    origin = (lo * b).astype(np.float32)
    dims = tuple(int(d) for d in dims)
    nx, ny, nz = dims
    ncells = nx * ny * nz

    xyz, mask = cloud.xyz, cloud.mask
    c = jnp.floor((xyz - jnp.asarray(origin)[None, :]) / b).astype(
        jnp.int32
    )
    c = jnp.clip(c, 0, jnp.asarray([nx - 1, ny - 1, nz - 1], jnp.int32))
    key = (c[:, 0] * ny + c[:, 1]) * nz + c[:, 2]
    key = jnp.where(mask, key, ncells)
    w = mask.astype(jnp.float32)
    cnt = jax.ops.segment_sum(w, key, num_segments=ncells + 1)[:ncells]
    # Pivot at the voxel corner for covariance stability (local extents).
    piv = c.astype(jnp.float32) * b + jnp.asarray(origin)[None, :]
    d = (xyz - piv) * w[:, None]
    s1 = jax.ops.segment_sum(d, key, num_segments=ncells + 1)[:ncells]
    s2 = jax.ops.segment_sum(
        jnp.einsum("ni,nj->nij", d, d), key, num_segments=ncells + 1
    )[:ncells]
    cnt_safe = jnp.maximum(cnt, 1.0)
    mu = s1 / cnt_safe[:, None]
    cov = s2 / cnt_safe[:, None, None] - jnp.einsum(
        "ni,nj->nij", mu, mu
    )
    # Back to world means; sparse voxels isotropic like the sorted form.
    grid_pos = jnp.stack(
        jnp.meshgrid(
            jnp.arange(nx), jnp.arange(ny), jnp.arange(nz),
            indexing="ij",
        ),
        axis=-1,
    ).reshape(ncells, 3).astype(jnp.float32) * b + jnp.asarray(origin)
    mean = mu + grid_pos
    eye = jnp.eye(3, dtype=jnp.float32)
    cov = jnp.where(
        (cnt >= 3.0)[:, None, None], cov + 1e-6 * eye, eye * b * b
    )
    valid = cnt >= 1.0
    mean = jnp.where(valid[:, None], mean, 0.0)
    return origin, dims, mean, cov, valid, b


def align(
    source: PointCloud,
    target: PointCloud,
    method: str = "gicp",
    init: Optional[np.ndarray] = None,
    max_iterations: int = 50,
    max_correspondence_distance: float = 1.0,
    translation_eps: float = 1e-4,
    rotation_eps: float = 1e-4,
    relative_error_eps: float = 1e-6,
    min_correspondences: int = 10,
    kernel: str = "none",
    kernel_scale: float = 1.0,
    knn_covariance: int = 10,
    voxel_size: float = 0.5,
    optimizer: str = "gn",
    init_lambda: float = 1e-3,
    lambda_factor: float = 10.0,
    max_inner_iterations: int = 10,
    covariance_epsilon: float = 1e-3,
    driver: str = "fused",
    knn_method: str = "auto",
    knn_bucket_size: Optional[float] = None,
    correspondence: str = "dense",
) -> RegistrationResult:
    """Align source to target (nanopcl::registration::align equivalent).

    Correspondences use a dense [Ns, Nt] distance tile per iteration
    (a matmul, exact); memory is Ns*Nt*4 bytes, so voxel-downsample
    inputs beyond ~30K points or use method="vgicp", whose correspondence
    is the voxel CONTAINING the transformed point (searchsorted over the
    sorted voxel-key table; reference voxel_correspondence.hpp:61) with
    Segal-regularized voxel covariances.

    ``optimizer``: "gn" (Gauss-Newton, fixed tiny damping) or "lm"
    (Levenberg-Marquardt with the reference's adaptive schedule,
    optimizers/lm_optimizer.hpp:52-85: accept a trial step only if the
    re-evaluated error drops — lambda /= lambda_factor on success, *=
    on failure, up to ``max_inner_iterations`` trials per outer step).

    ``knn_method``/``knn_bucket_size``: neighbor search used for the
    normal/covariance preparation ("auto" = exact brute kNN; "bucket" =
    voxel-bucket candidates — at 50K+ points the exact any-N kNN's
    ~N^2 top-k merges dominate the whole align wall time, and the
    bucket search cuts that prep by an order of magnitude at the cost
    of approximate neighborhoods, which GICP covariances tolerate).

    ``driver``: "fused" (default) runs the whole GN/LM loop as ONE jitted
    lax.while_loop program — one device dispatch per align instead of one
    per iteration (see _build_fused_driver); "host" keeps the per-step
    Python loop (useful for debugging / inspecting intermediates). Both
    execute the same mathematics.
    """
    if optimizer not in ("gn", "lm"):
        raise ValueError(f"unknown optimizer: {optimizer!r}")
    from fastdem_tpu.cloud import normals as nrm

    T = jnp.asarray(
        init if init is not None else np.eye(4), dtype=jnp.float32
    )

    t_normals = jnp.zeros_like(target.xyz)
    s_cov = jnp.zeros((source.capacity, 3, 3), dtype=jnp.float32)
    t_cov = jnp.zeros((target.capacity, 3, 3), dtype=jnp.float32)
    t_xyz, t_mask = target.xyz, target.mask

    if method == "point_to_plane":
        if "normal" not in target.channels:
            target = nrm.estimate_normals(
                target, k=knn_covariance, method=knn_method,
                bucket_size=knn_bucket_size,
            )
        t_normals = target.channels["normal"]
    elif method == "gicp":
        if "covariance" not in source.channels:
            source = nrm.estimate_covariances(
                source, k=knn_covariance, method=knn_method,
                bucket_size=knn_bucket_size,
            )
        if "covariance" not in target.channels:
            target = nrm.estimate_covariances(
                target, k=knn_covariance, method=knn_method,
                bucket_size=knn_bucket_size,
            )
        s_cov = source.channels["covariance"]
        t_cov = target.channels["covariance"]
    corr = "nearest"
    corr_dims = None
    vox_keys = jnp.zeros(1, dtype=jnp.int32)
    if method == "vgicp":
        if "covariance" not in source.channels:
            source = nrm.estimate_covariances(
                source, k=knn_covariance, method=knn_method,
                bucket_size=knn_bucket_size,
            )
        s_cov = source.channels["covariance"]
        if correspondence == "dense":
            # Dense lattice-aligned table: arithmetic containing-voxel
            # ids, one row gather per field per iteration (the
            # sorted+searchsorted form pays ~34 gathers per point per
            # pass).
            origin_v, dims_v, vmean, vcov, vvalid, b_eff = (
                voxel_distribution_table(target, voxel_size)
            )
            t_xyz = vmean
            t_mask = vvalid
            t_cov = jnp.where(
                vvalid[:, None, None],
                segal_regularize(vcov, covariance_epsilon),
                jnp.eye(3, dtype=jnp.float32),
            )
            vox_keys = jnp.asarray(origin_v)
            corr = "voxel_dense"
            corr_dims = dims_v
            voxel_size = b_eff
        elif correspondence == "sorted":
            vkeys, vmean, vcov, vvalid = voxel_distributions(
                target, voxel_size
            )
            # Containing-voxel correspondence against the distribution
            # table; covariances Segal-regularized like lookupRegularized.
            t_xyz = vmean
            t_mask = vvalid
            t_cov = jnp.where(
                vvalid[:, None, None],
                segal_regularize(vcov, covariance_epsilon),
                jnp.eye(3, dtype=jnp.float32),
            )
            vox_keys = vkeys
            corr = "voxel"
        else:
            raise ValueError(
                f"unknown correspondence: {correspondence!r}"
            )
        method = "gicp"

    args = lambda: (  # noqa: E731
        source.xyz, source.mask, t_xyz, t_mask, t_normals, s_cov, t_cov,
        vox_keys,
    )

    if driver == "fused":
        run = _fused_driver_cached(
            optimizer, method, kernel, kernel_scale,
            max_correspondence_distance, corr, voxel_size,
            max_iterations, translation_eps, rotation_eps,
            init_lambda, lambda_factor, max_inner_iterations,
            relative_error_eps, min_correspondences, corr_dims,
        )
        T, it_j, conv_j, err_j, n_corr_j = run(T, *args())
        return RegistrationResult(
            T=np.asarray(T),
            converged=bool(conv_j),
            iterations=int(it_j),
            error=float(err_j),
            num_correspondences=int(n_corr_j),
        )
    if driver != "host":
        raise ValueError(f"unknown driver: {driver!r}")

    _, (step, err_fn, linearize_fn, solve_retract) = _step_fns_cached(
        method, kernel, kernel_scale, max_correspondence_distance, corr,
        voxel_size, corr_dims,
    )

    def _small(delta):
        return (
            np.linalg.norm(delta[:3]) < translation_eps
            and np.linalg.norm(delta[3:]) < rotation_eps
        )

    def _stalled(prev_err, cur_err):
        # criteria.hpp:48-52 is_stalled (prev initialized huge -> ~1.0).
        return abs(prev_err - cur_err) / max(prev_err, 1e-30) < (
            relative_error_eps
        )

    converged = False
    err = float("inf")
    n_corr = 0
    it = 0
    if optimizer == "gn":
        lam = jnp.float32(1e-6)
        prev_err = 3.4e38
        for it in range(1, max_iterations + 1):
            T_new, delta, err_j, n_corr_j = step(T, lam, *args())
            delta = np.asarray(delta)
            err = float(err_j)
            n_corr = int(n_corr_j)
            if n_corr < min_correspondences:
                it -= 1  # failed result at the pre-step transform
                break
            T = T_new
            if _small(delta) or _stalled(prev_err, err):
                converged = True
                break
            prev_err = err
    else:  # adaptive LM
        lam = float(init_lambda)
        err_j, n_corr_j = err_fn(T, *args())
        err = float(err_j)
        n_corr = int(n_corr_j)
        if n_corr < min_correspondences:
            it = 0
        else:
            for it in range(1, max_iterations + 1):
                accepted = False
                delta = np.zeros(6)
                prev_err = err
                # Linearize ONCE at T; lambda trials only re-solve +
                # re-check the error (reference lm_optimizer.hpp:52-85).
                H, g, _, _ = linearize_fn(T, *args())
                for _ in range(max_inner_iterations):
                    T_try, delta_j = solve_retract(H, g, T, jnp.float32(lam))
                    err_new_j, n_new_j = err_fn(T_try, *args())
                    err_new = float(err_new_j)
                    if err_new < err:
                        lam = max(lam / lambda_factor, 1e-12)
                        T = T_try
                        err = err_new
                        n_corr = int(n_new_j)
                        delta = np.asarray(delta_j)
                        accepted = True
                        break
                    lam = min(lam * lambda_factor, 1e8)
                if accepted and n_corr < min_correspondences:
                    break  # failed: too few correspondences
                if not accepted:
                    converged = True  # no improving step: local minimum
                    break
                if _small(delta) or _stalled(prev_err, err):
                    converged = True
                    break

    return RegistrationResult(
        T=np.asarray(T),
        converged=converged,
        iterations=it,
        error=err,
        num_correspondences=n_corr,
    )
