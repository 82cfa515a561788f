"""Full-pipeline integration tests (mirrors reference
tests/test_fastdem_integration.cpp: synthetic flat-ground fixture, both
estimators and sensor models, LOCAL-follows/GLOBAL-fixed semantics,
transforms, filters, dual-layer obstacle behavior, return codes)."""

import jax.numpy as jnp
import numpy as np
import pytest

from fastdem_tpu.cloud import pointcloud as pc
from fastdem_tpu.cloud import transform as tfm
from fastdem_tpu.config.config import (
    Config,
    EstimationType,
    MappingMode,
    SensorType,
)
from fastdem_tpu.grid.geometry import GridGeometry
from fastdem_tpu.grid.gridmap import layers
from fastdem_tpu.mapping.pipeline import FastDEM


def flat_ground_cloud(extent=3.0, step=0.1, z=0.0, noise=0.0, rng=None):
    """Synthetic flat ground grid (fixture like
    test_fastdem_integration.cpp:32-41)."""
    g = np.arange(-extent, extent + 1e-6, step, dtype=np.float32)
    xx, yy = np.meshgrid(g, g, indexing="ij")
    zz = np.full_like(xx, z)
    if noise and rng is not None:
        zz = zz + rng.normal(0, noise, size=zz.shape).astype(np.float32)
    pts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    return pc.from_numpy(pts, frame_id="lidar")


def make_mapper(**cfg_overrides):
    geom = GridGeometry.from_length(10.0, 10.0, 0.1)
    cfg = Config()
    for k, v in cfg_overrides.items():
        parts = k.split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        setattr(obj, parts[-1], v)
    return FastDEM(geom, cfg)


I4 = np.eye(4, dtype=np.float32)


class TestBasicPipeline:
    def test_flat_ground_kalman(self):
        m = make_mapper()
        assert m.integrate(flat_ground_cloud(z=0.5), I4, I4)
        elev = np.asarray(m.state.layers[layers.elevation])
        touched = np.isfinite(elev)
        assert touched.sum() > 100
        np.testing.assert_allclose(elev[touched], 0.5, atol=1e-5)

    def test_flat_ground_p2(self):
        m = make_mapper(**{"mapping.estimation_type": EstimationType.P2_QUANTILE})
        c = flat_ground_cloud(z=1.0)
        for _ in range(6):
            assert m.integrate(c, I4, I4)
        elev = np.asarray(m.state.layers[layers.elevation])
        touched = np.isfinite(elev)
        assert touched.sum() > 100
        np.testing.assert_allclose(elev[touched], 1.0, atol=1e-4)

    def test_empty_cloud_returns_false(self):
        m = make_mapper()
        empty = pc.from_numpy(np.zeros((0, 3)), capacity=4)
        assert not m.integrate(empty, I4, I4)

    def test_sensor_offset_transform(self):
        m = make_mapper()
        T_bs = np.asarray(tfm.make_transform(t=[0, 0, 1.0]))
        m.integrate(flat_ground_cloud(z=0.0), T_bs, I4)
        elev = np.asarray(m.state.layers[layers.elevation])
        np.testing.assert_allclose(elev[np.isfinite(elev)], 1.0, atol=1e-5)

    def test_world_rotation(self):
        m = make_mapper()
        # Points along +x; base rotated 90 deg -> world points along +y.
        pts = np.array([[2.0, 0.0, 0.3]], dtype=np.float32)
        cloud = pc.from_numpy(pts)
        T_wb = np.asarray(tfm.from_rpy(0, 0, np.pi / 2))
        m.integrate(cloud, I4, T_wb)
        geom = m.geom
        r, c, inside = geom.index_of(
            m.state.position, jnp.array([0.0, 2.0])
        )
        assert bool(inside)
        assert float(m.state.layers[layers.elevation][int(r), int(c)]) == (
            pytest.approx(0.3, abs=1e-5)
        )

    def test_both_sensor_models(self):
        for st in (SensorType.LIDAR, SensorType.RGBD, SensorType.CONSTANT):
            m = make_mapper(**{"sensor_model.type": st})
            assert m.integrate(flat_ground_cloud(z=0.2), I4, I4)

    def test_n_points_counts_scans(self):
        m = make_mapper()
        c = flat_ground_cloud(z=0.0)
        m.integrate(c, I4, I4)
        m.integrate(c, I4, I4)
        n = np.asarray(m.state.layers[layers.n_points])
        assert n.max() == 2.0


class TestFilters:
    def test_height_filter(self):
        m = make_mapper(**{"point_filter.z_min": -0.5, "point_filter.z_max": 0.5})
        pts = np.array(
            [[1.0, 1.0, 0.0], [2.0, 2.0, 5.0]], dtype=np.float32
        )
        m.integrate(pc.from_numpy(pts), I4, I4)
        elev = np.asarray(m.state.layers[layers.elevation])
        assert np.isfinite(elev).sum() == 1

    def test_range_filter(self):
        m = make_mapper(**{"point_filter.range_max": 2.0})
        pts = np.array(
            [[1.0, 0.0, 0.0], [4.0, 0.0, 0.0]], dtype=np.float32
        )
        m.integrate(pc.from_numpy(pts), I4, I4)
        elev = np.asarray(m.state.layers[layers.elevation])
        assert np.isfinite(elev).sum() == 1

    def test_range_filter_applied_in_base_frame(self):
        # Sensor offset by 3 m: a point 1 m from the sensor is 4 m from base.
        m = make_mapper(**{"point_filter.range_max": 2.0})
        T_bs = np.asarray(tfm.make_transform(t=[3.0, 0, 0]))
        pts = np.array([[1.0, 0.0, 0.0]], dtype=np.float32)
        m.integrate(pc.from_numpy(pts), T_bs, I4)
        elev = np.asarray(m.state.layers[layers.elevation])
        assert np.isfinite(elev).sum() == 0


class TestMappingModes:
    def test_local_map_follows_robot(self):
        m = make_mapper(**{"mapping.mode": MappingMode.LOCAL})
        m.integrate(flat_ground_cloud(1.0), I4, I4)
        T_wb = np.asarray(tfm.make_transform(t=[20.0, 0, 0]))
        cloud2 = flat_ground_cloud(1.0)
        # Cloud is in sensor frame; after T_wb it lands around x=20.
        m.integrate(cloud2, I4, T_wb)
        np.testing.assert_allclose(
            np.asarray(m.state.position), [20.0, 0.0], atol=1e-5
        )
        elev = np.asarray(m.state.layers[layers.elevation])
        assert np.isfinite(elev).sum() > 0

    def test_global_map_fixed(self):
        m = make_mapper(**{"mapping.mode": MappingMode.GLOBAL})
        m.integrate(flat_ground_cloud(1.0), I4, I4)
        T_wb = np.asarray(tfm.make_transform(t=[20.0, 0, 0]))
        m.integrate(flat_ground_cloud(1.0), I4, T_wb)
        np.testing.assert_allclose(np.asarray(m.state.position), [0.0, 0.0])
        # Points fell outside the fixed map; first scan survives.
        elev = np.asarray(m.state.layers[layers.elevation])
        assert np.isfinite(elev).sum() > 0

    def test_local_move_preserves_overlap(self):
        m = make_mapper(**{"mapping.mode": MappingMode.LOCAL})
        m.integrate(flat_ground_cloud(4.0, z=0.7), I4, I4)
        T_wb = np.asarray(tfm.make_transform(t=[2.0, 0, 0]))
        empty_far = pc.from_numpy(
            np.array([[0.0, 0.0, 0.7]], dtype=np.float32)
        )
        m.integrate(empty_far, I4, T_wb)
        # Overlapping region retains measurements.
        geom = m.geom
        r, c, inside = geom.index_of(m.state.position, jnp.array([0.0, 0.0]))
        assert bool(inside)
        assert np.isfinite(
            float(m.state.layers[layers.elevation][int(r), int(c)])
        )


class TestDualLayer:
    """Ground/obstacle separation (mirrors tests/test_dual_layer.cpp)."""

    def test_obstacle_from_overhang(self):
        m = make_mapper()
        pts = np.array(
            [[1.05, 1.05, 0.0], [1.05, 1.05, 2.0]], dtype=np.float32
        )
        m.integrate(pc.from_numpy(pts), I4, I4)
        geom = m.geom
        r, c, _ = geom.index_of(m.state.position, jnp.array([1.05, 1.05]))
        r, c = int(r), int(c)
        assert float(m.state.layers[layers.elevation][r, c]) == pytest.approx(
            0.0, abs=1e-6
        )
        assert float(m.state.layers[layers.obstacle][r, c]) == pytest.approx(2.0)
        assert float(m.state.layers[layers.elevation_max][r, c]) == (
            pytest.approx(2.0)
        )

    def test_obstacle_cleared_next_frame(self):
        m = make_mapper()
        pts = np.array(
            [[1.05, 1.05, 0.0], [1.05, 1.05, 2.0]], dtype=np.float32
        )
        m.integrate(pc.from_numpy(pts), I4, I4)
        # Second frame: only ground there -> obstacle overwritten to NaN.
        m.integrate(
            pc.from_numpy(np.array([[1.05, 1.05, 0.0]], dtype=np.float32)),
            I4, I4,
        )
        geom = m.geom
        r, c, _ = geom.index_of(m.state.position, jnp.array([1.05, 1.05]))
        assert np.isnan(float(m.state.layers[layers.obstacle][int(r), int(c)]))
        # elevation_max accumulates across frames.
        assert float(
            m.state.layers[layers.elevation_max][int(r), int(c)]
        ) == pytest.approx(2.0)


class TestCallbacks:
    def test_callbacks_fire(self):
        m = make_mapper()
        seen = []
        m.on_preprocessed = lambda aux: seen.append("pre")
        m.on_rasterized = lambda data: seen.append("ras")
        m.integrate(flat_ground_cloud(), I4, I4)
        assert seen == ["pre", "ras"]


class TestReset:
    def test_reset_clears(self):
        m = make_mapper()
        m.integrate(flat_ground_cloud(z=1.0), I4, I4)
        m.reset()
        assert bool(
            jnp.all(jnp.isnan(m.state.layers[layers.elevation]))
        )


class TestEdgeCases:
    def test_scan_fully_filtered_out(self):
        """All points removed by filters: integrate succeeds, map untouched
        (the reference returns false on empty PREPROCESS result; we no-op —
        same map state either way)."""
        m = make_mapper(**{"point_filter.z_min": 10.0})
        pts = np.zeros((50, 3), dtype=np.float32)
        before = np.asarray(m.state.layers[layers.elevation]).copy()
        m.integrate(pc.from_numpy(pts), I4, I4)
        after = np.asarray(m.state.layers[layers.elevation])
        np.testing.assert_array_equal(before, after)

    def test_scan_fully_outside_map(self):
        m = make_mapper()
        pts = np.full((50, 3), 100.0, dtype=np.float32)
        assert m.integrate(pc.from_numpy(pts), I4, I4)
        assert np.isnan(np.asarray(m.state.layers[layers.elevation])).all()

    def test_nan_points_ignored(self):
        m = make_mapper()
        pts = np.array(
            [[1.0, 1.0, 0.5], [np.nan, 1.0, 0.5], [1.0, np.nan, 0.5],
             [1.0, 1.0, np.nan]],
            dtype=np.float32,
        )
        m.integrate(pc.from_numpy(pts), I4, I4)
        elev = np.asarray(m.state.layers[layers.elevation])
        assert np.isfinite(elev).sum() == 1

    def test_single_point_scan(self):
        m = make_mapper()
        m.integrate(
            pc.from_numpy(np.array([[0.05, 0.05, 1.0]], dtype=np.float32)),
            I4, I4,
        )
        geom = m.geom
        r, c, _ = geom.index_of(m.state.position, jnp.array([0.05, 0.05]))
        assert float(m.state.layers[layers.elevation][int(r), int(c)]) == (
            pytest.approx(1.0)
        )

    def test_huge_coordinates_do_not_crash(self):
        m = make_mapper()
        pts = np.array([[1e8, -1e8, 1e6]], dtype=np.float32)
        assert m.integrate(pc.from_numpy(pts), I4, I4)

    def test_move_far_then_return(self):
        """LOCAL map teleported far away and back: old content gone, new
        content lands correctly (wrap-invalidation correctness)."""
        m = make_mapper()
        m.integrate(flat_ground_cloud(2.0, z=1.0), I4, I4)
        far = np.eye(4, dtype=np.float32); far[0, 3] = 1e4
        m.integrate(flat_ground_cloud(2.0, z=2.0), I4, far)
        back = np.eye(4, dtype=np.float32)
        m.integrate(flat_ground_cloud(2.0, z=3.0), I4, back)
        geom = m.geom
        r, c, _ = geom.index_of(m.state.position, jnp.array([0.0, 0.0]))
        v = float(m.state.layers[layers.elevation][int(r), int(c)])
        # Kalman blend of nothing-but-scan-3 => exactly 3.0 (old state was
        # invalidated twice).
        assert v == pytest.approx(3.0, abs=1e-4)


class TestAutoBucket:
    """Auto capacity bucketing in FastDEM.integrate:
    heavily masked frames (RGB-D invalid depth) are compacted host-side to
    the geometric capacity ladder; the map state must be bit-identical to
    the uncompacted path."""

    def _noisy_cloud(self, rng, n=20000, invalid_frac=0.65):
        pts = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
        pts[:, 2] = 0.3 * np.sin(pts[:, 0]) + 0.02 * rng.normal(size=n)
        bad = rng.random(n) < invalid_frac
        pts[bad] = np.nan  # invalid depth returns
        return pc.from_numpy(pts, frame_id="camera")

    def test_bucketed_bitexact_vs_full_capacity(self):
        rng = np.random.default_rng(7)
        clouds = [self._noisy_cloud(rng) for _ in range(3)]
        m_b = make_mapper(**{"sensor_model.type": SensorType.RGBD})
        m_f = make_mapper(**{"sensor_model.type": SensorType.RGBD})
        m_f.auto_bucket = False
        for c in clouds:
            assert c.valid_count < 0.45 * c.capacity
            assert m_b.integrate(c, I4, I4)
            assert m_f.integrate(c, I4, I4)
        for name in m_f.state.layers:
            a = np.asarray(m_b.state.layers[name])
            b = np.asarray(m_f.state.layers[name])
            np.testing.assert_array_equal(a, b, err_msg=name)

    def test_bucket_triggers_and_ladder_shape(self):
        rng = np.random.default_rng(3)
        c = self._noisy_cloud(rng, n=20000, invalid_frac=0.65)
        m = make_mapper(**{"sensor_model.type": SensorType.RGBD})
        seen = []
        m.on_preprocessed = lambda aux: seen.append(aux.world_xyz.shape[0])
        assert m.integrate(c, I4, I4)
        # ~7000 valid points -> 8192-capacity ladder program, not 20000.
        assert seen and seen[0] == pc.ladder_capacity(c.valid_count)
        assert seen[0] < c.capacity

    def test_full_scans_not_compacted(self):
        c = flat_ground_cloud()
        m = make_mapper()
        seen = []
        m.on_preprocessed = lambda aux: seen.append(aux.world_xyz.shape[0])
        assert m.integrate(c, I4, I4)
        assert seen and seen[0] == c.capacity

    def test_channels_survive_compaction(self):
        rng = np.random.default_rng(5)
        n = 8192
        pts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
        inten = np.linspace(0, 1, n).astype(np.float32)
        bad = rng.random(n) < 0.8
        pts[bad] = np.nan
        c = pc.from_numpy(pts, frame_id="lidar", intensity=inten)
        cb = pc.compact_to_bucket(c)
        keep = ~bad
        np.testing.assert_array_equal(
            np.asarray(cb.channels["intensity"])[: keep.sum()], inten[keep]
        )
        assert cb.capacity == pc.ladder_capacity(int(keep.sum()))
        assert cb.nominal_count == c.nominal_count
