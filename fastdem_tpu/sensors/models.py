"""Vectorized sensor noise models (constant / LiDAR / RGB-D).

Equivalents of the reference sensor models:
  * ConstantUncertaintyModel: sigma^2 * I
    (/root/reference/fastdem/include/fastdem/sensors/sensor_model.hpp:65-93)
  * LiDARSensorModel: Sigma = var_lat*I + (var_rad - var_lat) * d d^T with
    var_rad = max(sigma_r^2, 1e-6), var_lat = max((dist*sigma_theta)^2, 1e-6),
    fallback 0.01*I near the origin
    (/root/reference/fastdem/include/fastdem/sensors/lidar_model.hpp:64-89)
  * RGBDSensorModel (Nguyen et al. 2012): diag(var_lat, var_lat, var_norm),
    sigma_norm = a + b (d - c)^2, sigma_lat = f*d, fallback 0.01*I for d <= 0
    (/root/reference/fastdem/include/fastdem/sensors/rgbd_model.hpp:82-101)

Two interfaces:
  * ``compute_covariances`` — full f32[N, 3, 3], parity with the reference
    batch API (sensor_model.hpp:76-85). Used for the covariance channel.
  * ``z_variance_world`` — the fused hot path. The mapping pipeline only
    consumes Sigma_world[2,2] (src/elevation_mapping.cpp:57-59 reads
    covariance(2,2) after the R Sigma R^T rotation at src/fastdem.cpp:181-187).
    Sigma_world[2,2] = r3^T Sigma_sensor r3, where r3 is the third row of the
    sensor->world rotation; for each model this collapses to a few vector
    ops, so the [N, 3, 3] tensor never exists on the device. Numerics are
    identical (same formula, reassociated).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import jax.numpy as jnp

from fastdem_tpu.cloud.transform import HIGHEST

_MIN_VARIANCE = 1e-6  # PSD floor (lidar_model.hpp:53)
_FALLBACK_VARIANCE = 0.01  # near-origin / invalid-depth fallback [m^2]


@dataclasses.dataclass(frozen=True)
class ConstantModel:
    """Isotropic constant uncertainty; sigma is a standard deviation."""

    uncertainty: float = 0.1

    @property
    def variance(self) -> float:
        return self.uncertainty * self.uncertainty

    def compute_covariances(self, xyz: jnp.ndarray) -> jnp.ndarray:
        n = xyz.shape[0]
        return jnp.broadcast_to(
            jnp.eye(3, dtype=jnp.float32) * self.variance, (n, 3, 3)
        )

    def z_variance_world(self, xyz: jnp.ndarray, r3: jnp.ndarray) -> jnp.ndarray:
        # r3^T (v I) r3 = v for unit r3.
        return jnp.full(xyz.shape[0], self.variance, dtype=jnp.float32)


@dataclasses.dataclass(frozen=True)
class LiDARModel:
    """Radial/lateral beam noise model."""

    range_noise: float = 0.02  # sigma_r [m]
    angular_noise: float = 0.001  # sigma_theta [rad]

    def __post_init__(self):
        object.__setattr__(self, "range_noise", abs(self.range_noise))
        object.__setattr__(self, "angular_noise", abs(self.angular_noise))

    def _variances(self, xyz: jnp.ndarray):
        dist_sq = jnp.sum(xyz * xyz, axis=-1)
        dist = jnp.sqrt(dist_sq)
        var_radial = jnp.maximum(self.range_noise**2, _MIN_VARIANCE)
        var_lateral = jnp.maximum(
            (dist * self.angular_noise) ** 2, _MIN_VARIANCE
        )
        near_origin = dist_sq < 1e-6
        return dist, var_radial, var_lateral, near_origin

    def compute_covariances(self, xyz: jnp.ndarray) -> jnp.ndarray:
        dist, var_r, var_l, near = self._variances(xyz)
        d = xyz / jnp.maximum(dist, 1e-12)[:, None]
        eye = jnp.eye(3, dtype=jnp.float32)
        cov = var_l[:, None, None] * eye + (var_r - var_l)[:, None, None] * (
            d[:, :, None] * d[:, None, :]
        )
        fallback = eye * _FALLBACK_VARIANCE
        return jnp.where(near[:, None, None], fallback, cov)

    def z_variance_world(self, xyz: jnp.ndarray, r3: jnp.ndarray) -> jnp.ndarray:
        """r3^T Sigma r3 = var_lat + (var_rad - var_lat) * (r3 . d)^2."""
        dist, var_r, var_l, near = self._variances(xyz)
        d = xyz / jnp.maximum(dist, 1e-12)[:, None]
        proj = jnp.matmul(d, r3, precision=HIGHEST)
        var = var_l + (var_r - var_l) * proj * proj
        return jnp.where(near, _FALLBACK_VARIANCE, var)


@dataclasses.dataclass(frozen=True)
class RGBDModel:
    """Structured-light depth noise (Nguyen et al. 2012)."""

    normal_a: float = 0.001
    normal_b: float = 0.002
    normal_c: float = 0.4
    lateral_factor: float = 0.001

    def _variances(self, xyz: jnp.ndarray):
        depth = xyz[:, 2]
        diff = depth - self.normal_c
        sigma_norm = self.normal_a + self.normal_b * diff * diff
        var_norm = sigma_norm * sigma_norm
        sigma_lat = self.lateral_factor * depth
        var_lat = sigma_lat * sigma_lat
        invalid = depth <= 0.0
        return var_lat, var_norm, invalid

    def compute_covariances(self, xyz: jnp.ndarray) -> jnp.ndarray:
        var_lat, var_norm, invalid = self._variances(xyz)
        n = xyz.shape[0]
        cov = jnp.zeros((n, 3, 3), dtype=jnp.float32)
        cov = cov.at[:, 0, 0].set(var_lat)
        cov = cov.at[:, 1, 1].set(var_lat)
        cov = cov.at[:, 2, 2].set(var_norm)
        fallback = jnp.eye(3, dtype=jnp.float32) * _FALLBACK_VARIANCE
        return jnp.where(invalid[:, None, None], fallback, cov)

    def z_variance_world(self, xyz: jnp.ndarray, r3: jnp.ndarray) -> jnp.ndarray:
        """r3^T diag(vl, vl, vn) r3 = vl*(r3x^2 + r3y^2) + vn*r3z^2."""
        var_lat, var_norm, invalid = self._variances(xyz)
        w_lat = r3[0] * r3[0] + r3[1] * r3[1]
        w_norm = r3[2] * r3[2]
        var = var_lat * w_lat + var_norm * w_norm
        return jnp.where(invalid, _FALLBACK_VARIANCE, var)


SensorModel = Union[ConstantModel, LiDARModel, RGBDModel]


def create_sensor_model(cfg) -> SensorModel:
    """Factory from config (reference src/sensor_model.cpp:22-40)."""
    from fastdem_tpu.config.config import SensorModelConfig, SensorType

    assert isinstance(cfg, SensorModelConfig)
    if cfg.type == SensorType.LIDAR:
        return LiDARModel(cfg.lidar.range_noise, cfg.lidar.angular_noise)
    if cfg.type == SensorType.RGBD:
        return RGBDModel(
            cfg.rgbd.normal_a,
            cfg.rgbd.normal_b,
            cfg.rgbd.normal_c,
            cfg.rgbd.lateral_factor,
        )
    return ConstantModel(cfg.constant.uncertainty)
