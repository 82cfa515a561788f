"""SE(3) transforms for point clouds (nanoPCL core/transform.hpp equivalent).

Parity notes: ``transform_cloud`` rotates points and normals but NOT the
covariance channel, matching nanopcl::transformCloud
(/root/reference/fastdem/lib/nanoPCL/include/nanopcl/core/transform.hpp:14-82);
covariance rotation is applied explicitly by the pipeline
(src/fastdem.cpp:181-187) — or fused away entirely in the z-variance hot path
(see fastdem_tpu.sensors.models.z_variance_world).

Transforms are 4x4 float32 matrices. Helpers build them from rotation +
translation, RPY Euler angles, or exponential coordinates.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from fastdem_tpu.cloud.pointcloud import PointCloud

# float32 contractions are pinned to full precision per call: on a GPU a
# default-precision f32 matmul may run in TF32 (~3 decimal digits), which
# at 10 m range moves points by a centimetre, across 0.1 m cell borders.
HIGHEST = jax.lax.Precision.HIGHEST


def make_transform(R=None, t=None) -> jnp.ndarray:
    """Assemble a 4x4 transform from 3x3 rotation and 3-vector translation."""
    T = jnp.eye(4, dtype=jnp.float32)
    if R is not None:
        T = T.at[:3, :3].set(jnp.asarray(R, dtype=jnp.float32))
    if t is not None:
        T = T.at[:3, 3].set(jnp.asarray(t, dtype=jnp.float32))
    return T


def from_rpy(roll: float, pitch: float, yaw: float, t=(0.0, 0.0, 0.0)) -> jnp.ndarray:
    """ZYX Euler (yaw-pitch-roll) rotation + translation."""
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    R = jnp.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ],
        dtype=jnp.float32,
    )
    return make_transform(R, jnp.asarray(t, dtype=jnp.float32))


def inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form SE(3) inverse."""
    R = T[:3, :3]
    t = T[:3, 3]
    Ti = jnp.eye(4, dtype=T.dtype)
    Ti = Ti.at[:3, :3].set(R.T)
    Ti = Ti.at[:3, 3].set(-jnp.matmul(R.T, t, precision=HIGHEST))
    return Ti


def compose(*Ts: jnp.ndarray) -> jnp.ndarray:
    out = jnp.eye(4, dtype=jnp.float32)
    for T in Ts:
        out = jnp.matmul(out, T, precision=HIGHEST)
    return out


def rotation(T: jnp.ndarray) -> jnp.ndarray:
    return T[:3, :3]


def translation(T: jnp.ndarray) -> jnp.ndarray:
    return T[:3, 3]


def transform_points(xyz: jnp.ndarray, T: jnp.ndarray) -> jnp.ndarray:
    """Apply T to f32[N, 3] points: R @ p + t."""
    return jnp.matmul(xyz, T[:3, :3].T, precision=HIGHEST) + T[:3, 3]


def transform_cloud(
    cloud: PointCloud, T: jnp.ndarray, frame_id: str | None = None
) -> PointCloud:
    """Transform points and normals; covariance intentionally untouched
    (see module docstring). Optionally sets the frame id, mirroring the
    transformCloud(cloud, T, frame) overload used at src/fastdem.cpp:179."""
    new = dataclasses.replace(cloud, xyz=transform_points(cloud.xyz, T))
    if "normal" in cloud.channels:
        new = new.with_channel(
            "normal",
            jnp.matmul(cloud.channels["normal"], T[:3, :3].T, precision=HIGHEST),
        )
    if frame_id is not None:
        new = new.with_frame(frame_id)
    return new


def rotate_covariances(cov: jnp.ndarray, R: jnp.ndarray) -> jnp.ndarray:
    """Batched R @ Sigma @ R^T for f32[N, 3, 3] (src/fastdem.cpp:181-187)."""
    return jnp.einsum("ij,njk,lk->nil", R, cov, R, precision=HIGHEST)


# ---------------------------------------------------------------------------
# Minimal Lie helpers (for deskew interpolation and registration)
# ---------------------------------------------------------------------------


def quat_from_matrix(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z); branch-free Shepperd
    variant safe under jit."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    qw = jnp.sqrt(jnp.maximum(0.0, 1.0 + tr)) / 2.0
    qx = jnp.sqrt(jnp.maximum(0.0, 1.0 + m00 - m11 - m22)) / 2.0
    qy = jnp.sqrt(jnp.maximum(0.0, 1.0 - m00 + m11 - m22)) / 2.0
    qz = jnp.sqrt(jnp.maximum(0.0, 1.0 - m00 - m11 + m22)) / 2.0
    qx = jnp.copysign(qx, m21 - m12)
    qy = jnp.copysign(qy, m02 - m20)
    qz = jnp.copysign(qz, m10 - m01)
    q = jnp.stack([qw, qx, qy, qz])
    return q / jnp.linalg.norm(q)


def matrix_from_quat(q: jnp.ndarray) -> jnp.ndarray:
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=jnp.float32,
    )


def slerp(q0: jnp.ndarray, q1: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Spherical interpolation; t may be a vector (returns [T, 4])."""
    d = jnp.sum(q0 * q1)
    q1 = jnp.where(d < 0, -q1, q1)
    d = jnp.abs(d)
    theta = jnp.arccos(jnp.clip(d, -1.0, 1.0))
    sin_theta = jnp.sin(theta)
    t = jnp.atleast_1d(t)[:, None]
    # Fall back to lerp for nearly-parallel quaternions.
    w0 = jnp.where(sin_theta > 1e-6, jnp.sin((1 - t) * theta) / sin_theta, 1 - t)
    w1 = jnp.where(sin_theta > 1e-6, jnp.sin(t * theta) / sin_theta, t)
    q = w0 * q0[None, :] + w1 * q1[None, :]
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def so3_exp(omega: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: axis-angle 3-vector -> rotation matrix."""
    theta = jnp.linalg.norm(omega)
    small = theta < 1e-8
    theta_safe = jnp.where(small, 1.0, theta)
    k = omega / theta_safe
    K = jnp.array(
        [
            [0.0, -k[2], k[1]],
            [k[2], 0.0, -k[0]],
            [-k[1], k[0], 0.0],
        ],
        dtype=jnp.float32,
    )
    R = (
        jnp.eye(3, dtype=jnp.float32)
        + jnp.sin(theta) * K
        + (1.0 - jnp.cos(theta)) * jnp.matmul(K, K, precision=HIGHEST)
    )
    # First-order fallback near zero.
    K0 = jnp.array(
        [
            [0.0, -omega[2], omega[1]],
            [omega[2], 0.0, -omega[0]],
            [-omega[1], omega[0], 0.0],
        ],
        dtype=jnp.float32,
    )
    return jnp.where(small, jnp.eye(3, dtype=jnp.float32) + K0, R)


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """Twist (tx, ty, tz, wx, wy, wz) -> 4x4 transform (rotation applied
    about the origin; translation added directly — the Gauss-Newton update
    convention used by the registration solver)."""
    T = jnp.eye(4, dtype=jnp.float32)
    T = T.at[:3, :3].set(so3_exp(xi[3:]))
    T = T.at[:3, 3].set(xi[:3])
    return T


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> axis-angle vector."""
    cos_theta = jnp.clip((jnp.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    sin_theta = jnp.sin(theta)
    v = jnp.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]],
        dtype=jnp.float32,
    )
    scale = jnp.where(
        jnp.abs(sin_theta) > 1e-8, theta / (2.0 * sin_theta), 0.5
    )
    return scale * v
