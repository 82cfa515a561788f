"""Typed configuration with YAML loading and two-severity validation.

Mirrors the reference config system exactly — same YAML keys, defaults, and
the fatal-throw vs warn-and-clamp split:
  * structs: /root/reference/fastdem/include/fastdem/config/{fastdem,mapping,
    postprocess,sensor_model,rasterization}.hpp
  * parsing: /root/reference/fastdem/src/config_fastdem.cpp:26-126 (permissive
    key-by-key override of defaults)
  * validation: /root/reference/fastdem/src/config_fastdem.cpp:128-260
    (throw: kalman min>=max, unsorted P2 markers; warn+clamp otherwise)
  * postprocess parsing: /root/reference/fastdem/src/config_postprocess.cpp
"""

from __future__ import annotations

import dataclasses
import enum
import logging
from typing import Any, Mapping

log = logging.getLogger("fastdem_tpu.config")

FLOAT_MAX = 3.4028234663852886e38  # std::numeric_limits<float>::max()


class MappingMode(enum.Enum):
    LOCAL = "local"
    GLOBAL = "global"


class EstimationType(enum.Enum):
    KALMAN = "kalman_filter"
    P2_QUANTILE = "p2_quantile"


class SensorType(enum.Enum):
    CONSTANT = "constant"
    LIDAR = "lidar"
    RGBD = "rgbd"


class RasterMethod(enum.Enum):
    MAX = "max"
    MIN = "min"
    MEAN = "mean"
    MINMAX = "minmax"


# ---------------------------------------------------------------------------
# Library config structs (defaults match the reference headers exactly)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PointFilterConfig:
    z_min: float = -FLOAT_MAX
    z_max: float = FLOAT_MAX
    range_min: float = 0.0
    range_max: float = FLOAT_MAX


@dataclasses.dataclass
class KalmanConfig:
    min_variance: float = 0.0001
    max_variance: float = 0.01
    process_noise: float = 0.0


@dataclasses.dataclass
class P2Config:
    dn0: float = 0.01
    dn1: float = 0.16
    dn2: float = 0.50
    dn3: float = 0.84
    dn4: float = 0.99
    elevation_marker: int = 3
    max_sample_count: float = 0.0


@dataclasses.dataclass
class MappingConfig:
    mode: MappingMode = MappingMode.LOCAL
    estimation_type: EstimationType = EstimationType.KALMAN
    kalman: KalmanConfig = dataclasses.field(default_factory=KalmanConfig)
    p2: P2Config = dataclasses.field(default_factory=P2Config)


@dataclasses.dataclass
class LiDARSensorConfig:
    range_noise: float = 0.02
    angular_noise: float = 0.001


@dataclasses.dataclass
class RGBDSensorConfig:
    normal_a: float = 0.001
    normal_b: float = 0.002
    normal_c: float = 0.4
    lateral_factor: float = 0.001


@dataclasses.dataclass
class ConstantSensorConfig:
    uncertainty: float = 0.03


@dataclasses.dataclass
class SensorModelConfig:
    type: SensorType = SensorType.LIDAR
    lidar: LiDARSensorConfig = dataclasses.field(default_factory=LiDARSensorConfig)
    rgbd: RGBDSensorConfig = dataclasses.field(default_factory=RGBDSensorConfig)
    constant: ConstantSensorConfig = dataclasses.field(
        default_factory=ConstantSensorConfig
    )


@dataclasses.dataclass
class RaycastingConfig:
    enabled: bool = False
    height_conflict_threshold: float = 0.05
    log_odds_observed: float = 0.4
    log_odds_ghost: float = 0.2
    log_odds_max: float = 2.0
    clear_threshold: float = -1.0
    # Extension (no reference equivalent): observed-evidence multiplicity
    # source — "exact" (distinct z-voxel count, reference semantics) or
    # "span" (cell z-extent in voxels; no scatter cost, map-size
    # independent). See rasterize.rasterize_scatter_packed.
    voxel_count_mode: str = "exact"
    # Extensions: polar ray-field resolution. Halving azimuth bins roughly
    # doubles the p90 height deviation vs the DDA oracle (PARITY.md) and
    # halves the field; range bins per cell = 1 / range_bin_factor.
    num_azimuth_bins: int = 2048
    # Default 0.25 (4 range bins per cell): <5% of touched log-odds cells
    # deviate from the reference DDA with ghost decisions exact (PARITY.md
    # envelope); 0.5 halves the field at ~6% deviation (the fast preset
    # uses it).
    range_bin_factor: float = 0.25
    # Maximum ray range in meters; 0 = auto (derived from the point
    # filter's range_max, falling back to the map diagonal). Bounds the
    # polar field and enables the windowed resample on large global maps.
    max_range: float = 0.0
    # Extension: ray-min-height formulation. "polar" (default; the
    # fused fast path, <5% log-odds envelope vs the reference DDA) or
    # "sampled" — per-ray segment sampling at dt <= res/sqrt(2), the
    # exactness-first mode (every traversed cell sampled like the DDA;
    # ~2 orders of magnitude more scatter elements, offline use).
    method: str = "polar"


@dataclasses.dataclass
class Config:
    point_filter: PointFilterConfig = dataclasses.field(
        default_factory=PointFilterConfig
    )
    sensor_model: SensorModelConfig = dataclasses.field(
        default_factory=SensorModelConfig
    )
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    raycasting: RaycastingConfig = dataclasses.field(
        default_factory=RaycastingConfig
    )


# Post-processing configs -----------------------------------------------------


@dataclasses.dataclass
class InpaintingConfig:
    enabled: bool = False
    max_iterations: int = 3
    min_valid_neighbors: int = 2


@dataclasses.dataclass
class UncertaintyFusionConfig:
    enabled: bool = False
    search_radius: float = 0.15
    spatial_sigma: float = 0.05
    quantile_lower: float = 0.01
    quantile_upper: float = 0.99
    min_valid_neighbors: int = 3


@dataclasses.dataclass
class FeatureExtractionConfig:
    enabled: bool = False
    analysis_radius: float = 0.3
    min_valid_neighbors: int = 4
    step_lower_percentile: float = 0.05
    step_upper_percentile: float = 0.95


@dataclasses.dataclass
class PostProcessConfig:
    inpainting: InpaintingConfig = dataclasses.field(
        default_factory=InpaintingConfig
    )
    uncertainty_fusion: UncertaintyFusionConfig = dataclasses.field(
        default_factory=UncertaintyFusionConfig
    )
    feature_extraction: FeatureExtractionConfig = dataclasses.field(
        default_factory=FeatureExtractionConfig
    )


# ---------------------------------------------------------------------------
# Parsing (permissive key-by-key overrides, config_fastdem.cpp:26-126)
# ---------------------------------------------------------------------------


def _load(node: Mapping, key: str, obj: Any, attr: str, cast=None) -> None:
    if node and key in node and node[key] is not None:
        val = node[key]
        if cast is not None:
            val = cast(val)
        else:
            val = type(getattr(obj, attr))(val)
        setattr(obj, attr, val)


def _parse_estimation_type(s: str) -> EstimationType:
    if s == "kalman_filter":
        return EstimationType.KALMAN
    if s == "p2_quantile":
        return EstimationType.P2_QUANTILE
    log.warning(
        "[Config] Unknown estimation type '%s', defaulting to kalman_filter", s
    )
    return EstimationType.KALMAN


def _parse_mapping_mode(s: str) -> MappingMode:
    if s == "local":
        return MappingMode.LOCAL
    if s == "global":
        return MappingMode.GLOBAL
    log.warning("[Config] Unknown mapping mode '%s', defaulting to local", s)
    return MappingMode.LOCAL


def _parse_sensor_type(s: str) -> SensorType:
    if s in ("lidar", "laser"):
        return SensorType.LIDAR
    if s == "rgbd":
        return SensorType.RGBD
    if s in ("constant", "none"):
        return SensorType.CONSTANT
    log.warning("[Config] Unknown sensor_model.type '%s', defaulting to LiDAR", s)
    return SensorType.LIDAR


def parse_config(root: Mapping) -> Config:
    """Parse + validate (reference parseConfig, config_fastdem.cpp:264-268)."""
    cfg = _parse(root or {})
    validate(cfg)
    return cfg


def _parse(root: Mapping) -> Config:
    cfg = Config()
    n = root.get("mapping")
    if n:
        if n.get("mode"):
            cfg.mapping.mode = _parse_mapping_mode(str(n["mode"]))
        if n.get("type"):
            cfg.mapping.estimation_type = _parse_estimation_type(str(n["type"]))
        k = n.get("kalman")
        if k:
            _load(k, "min_variance", cfg.mapping.kalman, "min_variance")
            _load(k, "max_variance", cfg.mapping.kalman, "max_variance")
            _load(k, "process_noise", cfg.mapping.kalman, "process_noise")
        p = n.get("p2")
        if p:
            for key in ("dn0", "dn1", "dn2", "dn3", "dn4"):
                _load(p, key, cfg.mapping.p2, key)
            _load(p, "elevation_marker", cfg.mapping.p2, "elevation_marker", int)
            _load(p, "max_sample_count", cfg.mapping.p2, "max_sample_count")
    n = root.get("point_filter")
    if n:
        for key in ("z_min", "z_max", "range_min", "range_max"):
            _load(n, key, cfg.point_filter, key)
    n = root.get("raycasting")
    if n:
        _load(n, "enabled", cfg.raycasting, "enabled", bool)
        for key in (
            "height_conflict_threshold",
            "log_odds_observed",
            "log_odds_ghost",
            "log_odds_max",
            "clear_threshold",
        ):
            _load(n, key, cfg.raycasting, key)
        _load(n, "num_azimuth_bins", cfg.raycasting, "num_azimuth_bins", int)
        _load(n, "range_bin_factor", cfg.raycasting, "range_bin_factor")
        _load(n, "max_range", cfg.raycasting, "max_range")
        _load(n, "voxel_count_mode", cfg.raycasting, "voxel_count_mode", str)
        _load(n, "method", cfg.raycasting, "method", str)
        if "polar_field_impl" in n:
            log.warning(
                "[Config] raycasting.polar_field_impl is retired (one polar "
                "field implementation remains); ignoring it"
            )
    n = root.get("sensor_model")
    if n:
        if n.get("type"):
            cfg.sensor_model.type = _parse_sensor_type(str(n["type"]))
        l = n.get("lidar")
        if l:
            _load(l, "range_noise", cfg.sensor_model.lidar, "range_noise")
            _load(l, "angular_noise", cfg.sensor_model.lidar, "angular_noise")
        r = n.get("rgbd")
        if r:
            for key in ("normal_a", "normal_b", "normal_c", "lateral_factor"):
                _load(r, key, cfg.sensor_model.rgbd, key)
        c = n.get("constant")
        if c:
            _load(c, "uncertainty", cfg.sensor_model.constant, "uncertainty")
    return cfg


def validate(cfg: Config) -> None:
    """Two-severity validation; exact rules of config_fastdem.cpp:128-260."""
    m = cfg
    # --- Fatal ---
    if m.mapping.kalman.min_variance >= m.mapping.kalman.max_variance:
        raise ValueError(
            f"mapping.kalman: min_variance ({m.mapping.kalman.min_variance}) "
            f">= max_variance ({m.mapping.kalman.max_variance})"
        )

    def warn_clamp(name, obj, attr, lo, hi):
        val = getattr(obj, attr)
        if val < lo or val > hi:
            log.warning(
                "[Config] %s (%s) out of range [%s, %s], clamping", name, val, lo, hi
            )
            setattr(obj, attr, min(max(val, lo), hi))

    def warn_default(name, obj, attr, pred, default):
        val = getattr(obj, attr)
        if not pred(val):
            log.warning(
                "[Config] %s (%s) invalid, clamping to %s", name, val, default
            )
            setattr(obj, attr, default)

    rc = m.raycasting
    if rc.enabled:
        warn_default(
            "raycasting.height_conflict_threshold", rc,
            "height_conflict_threshold", lambda v: v > 0, 0.05,
        )
        warn_default(
            "raycasting.log_odds_observed", rc, "log_odds_observed",
            lambda v: v > 0, 0.4,
        )
        warn_default(
            "raycasting.log_odds_ghost", rc, "log_odds_ghost",
            lambda v: v > 0, 0.2,
        )
        warn_default(
            "raycasting.log_odds_max", rc, "log_odds_max", lambda v: v > 0, 2.0
        )
        warn_default(
            "raycasting.clear_threshold", rc, "clear_threshold",
            lambda v: v < 0, -1.0,
        )
        warn_default(
            "raycasting.voxel_count_mode", rc, "voxel_count_mode",
            lambda v: v in ("exact", "span"), "exact",
        )
        warn_default(
            "raycasting.method", rc, "method",
            lambda v: v in ("polar", "sampled"), "polar",
        )
        warn_default(
            "raycasting.num_azimuth_bins", rc, "num_azimuth_bins",
            lambda v: 64 <= v <= 16384, 2048,
        )
        warn_default(
            "raycasting.range_bin_factor", rc, "range_bin_factor",
            lambda v: 0.1 <= v <= 2.0, 0.25,
        )
        warn_default(
            "raycasting.max_range", rc, "max_range", lambda v: v >= 0, 0.0
        )

    warn_default(
        "mapping.kalman.min_variance", m.mapping.kalman, "min_variance",
        lambda v: v > 0, 0.0001,
    )
    warn_default(
        "mapping.kalman.process_noise", m.mapping.kalman, "process_noise",
        lambda v: v >= 0, 0.0,
    )
    warn_clamp(
        "mapping.p2.elevation_marker", m.mapping.p2, "elevation_marker", 0, 4
    )

    p2 = m.mapping.p2
    for i in range(5):
        attr = f"dn{i}"
        warn_clamp(f"mapping.p2.dn{i}", p2, attr, 0.0, 1.0)
    dns = [p2.dn0, p2.dn1, p2.dn2, p2.dn3, p2.dn4]
    if any(dns[i] > dns[i + 1] for i in range(4)):
        raise ValueError(
            "mapping.p2: markers must be sorted (dn0 <= dn1 <= dn2 <= dn3 <= "
            f"dn4), got {dns}"
        )

    sm = m.sensor_model
    warn_default(
        "sensor.lidar.range_noise", sm.lidar, "range_noise", lambda v: v > 0, 0.02
    )
    warn_default(
        "sensor.lidar.angular_noise", sm.lidar, "angular_noise",
        lambda v: v >= 0, 0.0,
    )
    warn_default(
        "sensor.constant.uncertainty", sm.constant, "uncertainty",
        lambda v: v > 0, 0.1,
    )
    for attr in ("normal_a", "normal_b", "normal_c", "lateral_factor"):
        warn_default(
            f"sensor.rgbd.{attr}", sm.rgbd, attr, lambda v: v >= 0, 0.0
        )


def load_config(path: str) -> Config:
    from fastdem_tpu.config.yamlsubset import load_yaml

    try:
        root = load_yaml(path)
    except Exception as e:  # noqa: BLE001 - mirror reference error wrapping
        raise RuntimeError(f"Failed to load config: {path} - {e}") from e
    return parse_config(root or {})


# Post-process parsing (config_postprocess.cpp:87-128) ------------------------


def parse_postprocess(root: Mapping) -> PostProcessConfig:
    cfg = PostProcessConfig()
    root = root or {}
    pp = root.get("post_processing", root)
    n = pp.get("inpainting")
    if n:
        _load(n, "enabled", cfg.inpainting, "enabled", bool)
        _load(n, "max_iterations", cfg.inpainting, "max_iterations", int)
        _load(n, "min_valid_neighbors", cfg.inpainting, "min_valid_neighbors", int)
    n = pp.get("uncertainty_fusion")
    if n:
        _load(n, "enabled", cfg.uncertainty_fusion, "enabled", bool)
        _load(n, "search_radius", cfg.uncertainty_fusion, "search_radius")
        _load(n, "spatial_sigma", cfg.uncertainty_fusion, "spatial_sigma")
        _load(n, "quantile_lower", cfg.uncertainty_fusion, "quantile_lower")
        _load(n, "quantile_upper", cfg.uncertainty_fusion, "quantile_upper")
        _load(
            n, "min_valid_neighbors", cfg.uncertainty_fusion,
            "min_valid_neighbors", int,
        )
    n = pp.get("feature_extraction")
    if n:
        _load(n, "enabled", cfg.feature_extraction, "enabled", bool)
        _load(n, "analysis_radius", cfg.feature_extraction, "analysis_radius")
        _load(
            n, "min_valid_neighbors", cfg.feature_extraction,
            "min_valid_neighbors", int,
        )
        _load(
            n, "step_lower_percentile", cfg.feature_extraction,
            "step_lower_percentile",
        )
        _load(
            n, "step_upper_percentile", cfg.feature_extraction,
            "step_upper_percentile",
        )
    return cfg


def load_postprocess(path: str) -> PostProcessConfig:
    from fastdem_tpu.config.yamlsubset import load_yaml

    return parse_postprocess(load_yaml(path) or {})
