"""Property sweep: the pipeline must trace, run, and produce sane maps for
every reachable config combination (estimator x mode x sensor x raycast x
scatter/voxel modes x channels). Guards against combinations that only
break when traced together (e.g., a rider path assuming a lane exists).

Shapes are tiny so each jit is cheap; this is a trace/shape/NaN-sanity
sweep, not a numerics test (those live in the per-component suites).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from fastdem_tpu import Config, GridGeometry
from fastdem_tpu.config.config import (
    EstimationType,
    MappingMode,
    SensorType,
    parse_config,
)
from fastdem_tpu.grid.gridmap import layers
from fastdem_tpu.mapping.pipeline import build_integrate, create_map_state

ESTS = [EstimationType.KALMAN, EstimationType.P2_QUANTILE]
MODES = [MappingMode.LOCAL, MappingMode.GLOBAL]
SENSORS = [SensorType.LIDAR, SensorType.RGBD, SensorType.CONSTANT]


def _scan(rng, n=512):
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(0.3, 3.0, n)
    z = 0.1 * np.sin(rad) - 1.0
    return np.column_stack(
        [rad * np.cos(ang), rad * np.sin(ang), z]
    ).astype(np.float32)


@pytest.mark.parametrize(
    "est,mode,sensor", list(itertools.product(ESTS, MODES, SENSORS))
)
def test_pipeline_traces_all_estimator_mode_sensor(est, mode, sensor, rng):
    geom = GridGeometry.from_length(8.0, 8.0, 0.25)
    cfg = Config()
    cfg.mapping.estimation_type = est
    cfg.mapping.mode = mode
    cfg.sensor_model.type = sensor
    cfg.raycasting.enabled = True
    step = build_integrate(geom, cfg, has_intensity=True, has_color=True,
                           donate=False)
    state = create_map_state(geom, cfg, has_intensity=True, has_color=True)
    xyz = jnp.asarray(_scan(rng))
    n = xyz.shape[0]
    from fastdem_tpu.utils.colors import pack_rgb

    color = pack_rgb(jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(np.float32)))
    inten = jnp.asarray(rng.uniform(0, 50, n).astype(np.float32))
    T_bs = jnp.eye(4).at[2, 3].set(0.8)
    # 8 scans: the P2 estimator's elevation is q[marker], NaN until the
    # per-cell 5-sample phase-1 warm-up completes (quantile_estimation.hpp
    # :141-163 semantics).
    for k in range(8):
        T_wb = jnp.eye(4).at[0, 3].set(0.05 * k)
        state, _ = step(
            state, xyz, jnp.ones(n, bool), T_bs, T_wb, inten, color
        )
    elev = np.asarray(state.layers[layers.elevation])
    assert np.isfinite(elev).sum() > 50
    # Sane estimates: ground sits at sensor-frame z ~= -1.0, sensor at
    # z = 0.8 in the base frame -> world heights ~= -0.2.
    assert abs(np.nanmedian(elev) + 0.2) < 0.5
    var = np.asarray(state.layers[layers.variance])
    assert np.nanmin(var) >= 0.0


def test_ray_field_resolution_config_keys(rng):
    """raycasting.num_azimuth_bins / range_bin_factor (extension keys)
    parse, clamp, and reach the compiled pipeline."""
    from fastdem_tpu.config.config import parse_config

    cfg = parse_config(
        {"raycasting": {"enabled": True, "num_azimuth_bins": 1024,
                        "range_bin_factor": 1.0,
                        "voxel_count_mode": "span"}}
    )
    assert cfg.raycasting.num_azimuth_bins == 1024
    assert cfg.raycasting.range_bin_factor == 1.0
    # Out-of-range values warn-and-clamp to defaults.
    bad = parse_config(
        {"raycasting": {"enabled": True, "num_azimuth_bins": 7,
                        "range_bin_factor": 99.0}}
    )
    assert bad.raycasting.num_azimuth_bins == 2048
    assert bad.raycasting.range_bin_factor == 0.25  # r2 accuracy default

    geom = GridGeometry.from_length(8.0, 8.0, 0.25)
    step = build_integrate(geom, cfg, donate=False)
    state = create_map_state(geom, cfg)
    xyz = jnp.asarray(_scan(rng))
    state, _ = step(
        state, xyz, jnp.ones(xyz.shape[0], bool),
        jnp.eye(4).at[2, 3].set(0.8), jnp.eye(4),
    )
    assert np.isfinite(np.asarray(state.layers[layers.elevation])).sum() > 50


def test_fast_preset_loads(rng):
    from fastdem_tpu.runtime.node_config import NodeConfig

    cfg = NodeConfig.load(
        "fastdem_tpu/config/presets/local_mapping_fast.yaml"
    )
    assert cfg.pipeline.raycasting.voxel_count_mode == "span"
    assert cfg.pipeline.raycasting.num_azimuth_bins == 1024


@pytest.mark.parametrize(
    "scatter_mode,voxel_count_mode,exact_window",
    [
        ("rows", "exact", True),
        ("rows", "exact", False),
        ("rows", "span", True),
        ("packed", "exact", True),
        ("packed", "exact", False),
        ("packed", "span", True),
        ("twophase", "exact", True),
        ("twophase", "exact", False),
    ],
)
def test_pipeline_traces_all_kernel_modes(
    scatter_mode, voxel_count_mode, exact_window, rng
):
    geom = GridGeometry.from_length(8.0, 8.0, 0.25)
    cfg = Config()
    cfg.raycasting.enabled = True
    step = build_integrate(
        geom, cfg, donate=False, scatter_mode=scatter_mode,
        voxel_count_mode=voxel_count_mode, ray_exact_window=exact_window,
    )
    state = create_map_state(geom, cfg)
    xyz = jnp.asarray(_scan(rng))
    state, _ = step(
        state, xyz, jnp.ones(xyz.shape[0], bool),
        jnp.eye(4).at[2, 3].set(0.8), jnp.eye(4),
    )
    assert np.isfinite(np.asarray(state.layers[layers.elevation])).sum() > 50


def test_raycast_sampled_method(rng):
    """raycasting.method="sampled" (exactness-first per-ray sampling)
    traces, runs, and produces a ray layer comparable to the polar path."""
    geom = GridGeometry.from_length(8.0, 8.0, 0.25)
    states = {}
    for method in ("polar", "sampled"):
        cfg = Config()
        cfg.raycasting.enabled = True
        cfg.raycasting.method = method
        step = build_integrate(geom, cfg, donate=False)
        state = create_map_state(geom, cfg)
        xyz = jnp.asarray(_scan(rng))
        state, _ = step(
            state, xyz, jnp.ones(xyz.shape[0], bool),
            jnp.eye(4).at[2, 3].set(1.0), jnp.eye(4),
        )
        states[method] = state
    a = np.asarray(states["polar"].layers["raycasting"])
    b = np.asarray(states["sampled"].layers["raycasting"])
    both = np.isfinite(a) & np.isfinite(b)
    assert both.sum() > 50
    assert np.percentile(np.abs(a[both] - b[both]), 90) < 0.2


def test_raycast_method_yaml_key():
    from fastdem_tpu.config.config import validate

    cfg = parse_config({"raycasting": {"enabled": True, "method": "sampled"}})
    validate(cfg)
    assert cfg.raycasting.method == "sampled"
    cfg2 = parse_config(
        {"raycasting": {"enabled": True, "method": "bogus"}}
    )
    validate(cfg2)
    assert cfg2.raycasting.method == "polar"  # warn-and-clamp
