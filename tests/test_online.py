"""Online-mode tests with mock providers + failure injection (mirrors
reference tests/test_online_mode.cpp:20-175) and driver behavior."""

import os

import numpy as np
import pytest

from fastdem_tpu.cloud import pointcloud as pc
from fastdem_tpu.config.config import Config, PostProcessConfig
from fastdem_tpu.grid.geometry import GridGeometry
from fastdem_tpu.grid.gridmap import layers
from fastdem_tpu.mapping.pipeline import FastDEM
from fastdem_tpu.runtime.driver import MappingDriver
from fastdem_tpu.runtime.providers import (
    StaticCalibration,
    StaticOdometry,
    TransformBuffer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cloud(frame="lidar", n=100, t=1_000_000_000):
    rng = np.random.default_rng(0)
    pts = np.column_stack(
        [rng.uniform(-3, 3, n), rng.uniform(-3, 3, n), np.zeros(n)]
    ).astype(np.float32)
    return pc.from_numpy(pts, frame_id=frame, timestamp_ns=t)


def make_mapper():
    geom = GridGeometry.from_length(10.0, 10.0, 0.1)
    m = FastDEM(geom, Config())
    calib = StaticCalibration()
    calib.set_extrinsic("lidar", np.eye(4, dtype=np.float32))
    odom = StaticOdometry()
    m.set_calibration_provider(calib)
    m.set_odometry_provider(odom)
    return m, calib, odom


class TestOnlineMode:
    def test_provider_integrate(self):
        m, _, _ = make_mapper()
        assert m.integrate(cloud())
        elev = np.asarray(m.state.layers[layers.elevation])
        assert np.isfinite(elev).sum() > 0

    def test_no_providers_fails(self):
        geom = GridGeometry.from_length(5.0, 5.0, 0.1)
        m = FastDEM(geom, Config())
        assert not m.integrate(cloud())

    def test_calibration_failure_drops_scan(self):
        m, calib, _ = make_mapper()
        calib.fail = True
        assert not m.integrate(cloud())

    def test_odometry_failure_drops_scan(self):
        m, _, odom = make_mapper()
        odom.fail = True
        assert not m.integrate(cloud())

    def test_unknown_frame(self):
        m, _, _ = make_mapper()
        assert not m.integrate(cloud(frame="unknown_sensor"))

    def test_missing_frame_id(self):
        m, _, _ = make_mapper()
        assert not m.integrate(cloud(frame=""))

    def test_recovers_after_failure(self):
        m, calib, _ = make_mapper()
        calib.fail = True
        assert not m.integrate(cloud())
        calib.fail = False
        assert m.integrate(cloud())


class TestTransformBuffer:
    def test_extrinsic_cache(self):
        buf = TransformBuffer()
        T = np.eye(4)
        buf.set_extrinsic("cam", T)
        assert buf.get_extrinsic("cam") is not None
        assert buf.get_extrinsic("") is None
        assert buf.get_extrinsic("nope") is None

    def test_pose_interpolation(self):
        buf = TransformBuffer(max_stale_time=10.0)
        T0 = np.eye(4)
        T1 = np.eye(4)
        T1[0, 3] = 2.0
        buf.add_pose(0, T0)
        buf.add_pose(2_000_000_000, T1)
        T = buf.get_pose_at(1_000_000_000)
        np.testing.assert_allclose(T[0, 3], 1.0, atol=1e-6)

    def test_staleness_rejected(self):
        buf = TransformBuffer(max_stale_time=0.1)
        buf.add_pose(0, np.eye(4))
        assert buf.get_pose_at(10_000_000_000) is None

    def test_latest_fallback(self):
        buf = TransformBuffer(max_stale_time=0.1, use_latest_fallback=True)
        T = np.eye(4)
        T[1, 3] = 5.0
        buf.add_pose(0, T)
        out = buf.get_pose_at(10_000_000_000)
        assert out is not None and out[1, 3] == 5.0

    def test_zero_timestamp_latest(self):
        buf = TransformBuffer(max_stale_time=0.0)
        buf.add_pose(123, np.eye(4))
        assert buf.get_pose_at(0) is not None

    def test_empty_buffer(self):
        buf = TransformBuffer()
        assert buf.get_pose_at(100) is None


class TestDriver:
    def make_driver(self, **kw):
        geom = GridGeometry.from_length(8.0, 8.0, 0.1)
        calib = StaticCalibration()
        calib.set_extrinsic("lidar", np.eye(4, dtype=np.float32))
        pp = PostProcessConfig()
        pp.inpainting.enabled = True
        return MappingDriver(
            geom,
            Config(),
            postprocess_cfg=pp,
            calibration=calib,
            odometry=StaticOdometry(),
            postprocess_rate=0.0,  # manual triggering in tests
            viz_rate=0.0,
            **kw,
        )

    def test_scan_and_services(self):
        with self.make_driver() as d:
            assert d.on_scan(cloud())
            out = d.run_postprocess()
            assert "elevation" in out and "uncertainty_range" in out
            d.reset()
            assert np.all(
                np.isnan(np.asarray(d.mapper.state.layers[layers.elevation]))
            )

    def test_individual_services(self):
        with self.make_driver() as d:
            d.on_scan(cloud())
            assert "elevation" in d.run_inpainting()
            assert "upper_bound" in d.run_uncertainty_fusion()
            assert "slope" in d.run_feature_extraction()

    def test_sink_publishing(self):
        with self.make_driver() as d:
            got = []
            d.sinks["postprocess"] = lambda p: got.append(p)
            d.on_scan(cloud())
            d.run_postprocess()
            assert len(got) == 1

    def test_submap(self):
        with self.make_driver() as d:
            d.on_scan(cloud())
            sub = d.submap((0.0, 0.0), (2.0, 2.0))
            assert sub["elevation"].shape == (20, 20)

    def test_async_intake_matches_sync(self):
        """Async intake (queue + burst worker) must produce the same map as
        the synchronous path for the same scan stream (no drops)."""
        rng = np.random.default_rng(1)
        scans = []
        for k in range(7):
            n = 600
            pts = np.column_stack(
                [rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                 0.05 * rng.standard_normal(n)]
            ).astype(np.float32)
            scans.append(
                pc.from_numpy(pts, frame_id="lidar",
                              timestamp_ns=(k + 1) * 10**9)
            )

        with self.make_driver() as d_sync:
            for s in scans:
                assert d_sync.on_scan(s)
            ref = {
                k: np.asarray(v) for k, v in d_sync.mapper.state.layers.items()
            }

        with self.make_driver(
            async_intake=True, burst_batch=3, max_queue=64
        ) as d:
            for s in scans:
                assert d.on_scan(s)
            assert d.drain(timeout=120.0)
            assert d.dropped_scans == 0
            assert d._scan_count == 7
            for name, a in ref.items():
                b = np.asarray(d.mapper.state.layers[name])
                np.testing.assert_array_equal(
                    np.isnan(a), np.isnan(b), err_msg=name
                )
                both = np.isfinite(a) & np.isfinite(b)
                np.testing.assert_array_equal(a[both], b[both], err_msg=name)

    def test_async_intake_explicit_transforms_and_drops(self):
        with self.make_driver(
            async_intake=True, burst_batch=2, max_queue=3
        ) as d:
            T = np.eye(4, dtype=np.float32)
            for k in range(12):
                assert d.on_scan(cloud(t=(k + 1) * 10**9), T, T)
            assert d.drain(timeout=120.0)
            # Oldest scans beyond the queue bound drop; the rest integrate.
            assert d._scan_count + d.dropped_scans == 12
            assert d._scan_count >= 3

    def test_async_intake_with_timers_and_services(self):
        """Threaded-runtime interplay: async burst intake, the viz and
        postprocess timers, and service calls all running concurrently
        must not race (facade access is serialized by the driver lock)
        and must end with a consistent, fully-integrated map."""
        import time

        geom = GridGeometry.from_length(8.0, 8.0, 0.1)
        calib = StaticCalibration()
        calib.set_extrinsic("lidar", np.eye(4, dtype=np.float32))
        pp = PostProcessConfig()
        pp.inpainting.enabled = True
        published = []
        with MappingDriver(
            geom,
            Config(),
            postprocess_cfg=pp,
            calibration=calib,
            odometry=StaticOdometry(),
            postprocess_rate=15.0,
            viz_rate=15.0,
            async_intake=True,
            burst_batch=3,
            max_queue=64,
        ) as d:
            d.sinks["local_map"] = lambda p: published.append("viz")
            d.sinks["postprocess"] = lambda p: published.append("pp")
            for k in range(9):
                assert d.on_scan(cloud(t=(k + 1) * 10**9))
                if k == 4:
                    d.run_inpainting()  # service mid-stream
                time.sleep(0.02)
            assert d.drain(timeout=120.0)
            out = d.run_postprocess()
            assert "elevation" in out
            assert d._scan_count == 9
            assert d.dropped_scans == 0
        elev = np.asarray(d.mapper.state.layers[layers.elevation])
        assert np.isfinite(elev).sum() > 50

    def test_timers_fire(self):
        import time

        geom = GridGeometry.from_length(6.0, 6.0, 0.1)
        calib = StaticCalibration()
        calib.set_extrinsic("lidar", np.eye(4, dtype=np.float32))
        got = []
        with MappingDriver(
            geom,
            Config(),
            calibration=calib,
            odometry=StaticOdometry(),
            postprocess_rate=20.0,
            viz_rate=20.0,
        ) as d:
            d.sinks["map"] = lambda p: got.append(p)
            d.on_scan(cloud())
            t0 = time.time()
            while not got and time.time() - t0 < 10:
                time.sleep(0.05)
        assert got, "viz timer never published"
        assert got[0]["scan_count"] == 1
        assert not any(k.startswith("_") for k in got[0]["layers"])


class TestBridge:
    def make_state(self):
        import jax.numpy as jnp

        from fastdem_tpu.grid import gridmap
        from fastdem_tpu.grid.geometry import GridGeometry

        geom = GridGeometry.from_length(2.0, 2.0, 0.5)
        fills = gridmap.default_layer_fills()
        fills["variance"] = 0.0
        fills["_internal_thing"] = 0.0
        state = gridmap.create(geom, fills)
        elev = jnp.full(geom.shape, jnp.nan).at[1, 1].set(0.5).at[2, 2].set(1.0)
        return geom, state.replace_layer(layers.elevation, elev)

    def test_structured_cloud(self):
        from fastdem_tpu.runtime import bridge

        geom, state = self.make_state()
        arr = bridge.to_structured_cloud(geom, state)
        assert arr.shape[0] == 2
        assert "variance" in arr.dtype.names
        assert "_internal_thing" not in arr.dtype.names
        assert set(arr["z"]) == {0.5, 1.0}

    def test_grid_message_excludes_internal(self):
        from fastdem_tpu.runtime import bridge

        geom, state = self.make_state()
        msg = bridge.to_grid_message(geom, state)
        assert "_internal_thing" not in msg["layers"]
        assert msg["size"] == (4, 4)

    def test_normal_markers(self):
        import jax.numpy as jnp

        from fastdem_tpu.runtime import bridge

        geom, state = self.make_state()
        nan = jnp.full(geom.shape, jnp.nan)
        state = state.replace_layers(
            {
                layers.normal_x: nan.at[1, 1].set(0.0),
                layers.normal_y: nan.at[1, 1].set(0.0),
                layers.normal_z: nan.at[1, 1].set(1.0),
            }
        )
        m = bridge.to_normal_markers(geom, state)
        assert m["starts"].shape[0] == 1
        np.testing.assert_allclose(
            m["ends"][0, 2] - m["starts"][0, 2], 0.15, atol=1e-6
        )

    def test_boundary(self):
        from fastdem_tpu.runtime import bridge

        geom, state = self.make_state()
        poly = bridge.to_map_boundary(geom, state)
        assert poly.shape == (5, 2)
        np.testing.assert_allclose(poly[0], poly[-1])


class TestNodeConfig:
    def test_load_preset(self):
        from fastdem_tpu.runtime.node_config import NodeConfig

        cfg = NodeConfig.load(
            "fastdem_tpu/config/presets/local_mapping.yaml"
        )
        assert cfg.map.width == 15.0
        assert cfg.pipeline.raycasting.enabled
        assert cfg.postprocess.inpainting.enabled
        assert cfg.normals_viz.stride == 2

    def test_validation_throws(self):
        from fastdem_tpu.runtime.node_config import NodeConfig

        with pytest.raises(ValueError, match="map geometry"):
            NodeConfig.parse({"map": {"width": -1.0}})
        with pytest.raises(ValueError, match="input_scans"):
            NodeConfig.parse({"topics": {"input_scans": []}})

    def test_make_driver(self):
        from fastdem_tpu.runtime.node_config import NodeConfig

        cfg = NodeConfig.parse({"map": {"width": 4.0, "height": 4.0}})
        d = cfg.make_driver()
        try:
            assert d.geom.rows == 40
        finally:
            d.close()


class TestNodeCli:
    def test_node_synthetic_run(self, tmp_path):
        import os
        import subprocess
        import sys

        out = str(tmp_path / "out")
        r = subprocess.run(
            [
                sys.executable, "tools/fastdem_node.py",
                "--config", "fastdem_tpu/config/presets/local_mapping.yaml",
                "--synthetic", "4", "--out", out, "--platform", "cpu",
            ],
            capture_output=True, text=True, cwd=REPO, timeout=400,
            env=dict(os.environ),
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert "integrated 4 scans" in r.stdout
        assert os.path.exists(f"{out}/map_final.npz")
        assert os.path.exists(f"{out}/elevation.png")

    def test_node_file_scans(self, tmp_path):
        import os
        import subprocess
        import sys

        import numpy as np

        from fastdem_tpu.cloud import pointcloud as pc
        from fastdem_tpu.io import pcd as pcd_io

        scan_dir = tmp_path / "scans"
        scan_dir.mkdir()
        rng = np.random.default_rng(0)
        for i in range(3):
            pts = np.column_stack(
                [rng.uniform(-3, 3, 2000), rng.uniform(-3, 3, 2000),
                 rng.normal(-1.0, 0.02, 2000)]
            ).astype(np.float32)
            pcd_io.save_pcd(str(scan_dir / f"{i:03d}.pcd"), pc.from_numpy(pts))
        traj = tmp_path / "traj.txt"
        rows = [[i + 1, 0.2 * i, 0, 0, 0, 0, 0, 1] for i in range(3)]
        np.savetxt(str(traj), np.asarray(rows, dtype=float))
        out = str(tmp_path / "out")
        r = subprocess.run(
            [
                sys.executable, "tools/fastdem_node.py",
                "--config", "fastdem_tpu/config/presets/local_mapping.yaml",
                "--scans", str(scan_dir), "--trajectory", str(traj),
                "--out", out, "--platform", "cpu",
            ],
            capture_output=True, text=True, cwd=REPO, timeout=400,
            env=dict(os.environ),
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert "integrated 3 scans" in r.stdout


class TestGlobalTimer:
    def test_global_submap_published(self):
        import time

        from fastdem_tpu.runtime.driver import MappingDriver
        from fastdem_tpu.runtime.providers import StaticCalibration, StaticOdometry

        geom = GridGeometry.from_length(6.0, 6.0, 0.1)
        calib = StaticCalibration()
        calib.set_extrinsic("lidar", np.eye(4, dtype=np.float32))
        got = []
        with MappingDriver(
            geom, Config(),
            calibration=calib, odometry=StaticOdometry(),
            postprocess_rate=0.0, viz_rate=0.0,
            global_rate=20.0, global_window=(2.0, 2.0),
        ) as d:
            d.sinks["global_submap"] = lambda p: got.append(p)
            d.on_scan(cloud())
            t0 = time.time()
            while not got and time.time() - t0 < 10:
                time.sleep(0.05)
        assert got
        assert got[0]["elevation"].shape == (20, 20)


class TestWireSinks:
    def test_pointcloud2_sink_emits_real_message(self):
        """Subscribing a 'pointcloud2' sink yields a real
        sensor_msgs/PointCloud2 encoding from the viz loop (wire codecs,
        runtime/wire.py) — subscriber-gated like the reference topics."""
        import jax.numpy as jnp

        from fastdem_tpu import Config, GridGeometry
        from fastdem_tpu.runtime.driver import MappingDriver
        from fastdem_tpu.runtime.wire import PointCloud2

        geom = GridGeometry.from_length(4.0, 4.0, 0.5)
        drv = MappingDriver(geom, Config(), viz_rate=0.0)
        got = []
        drv.sinks["pointcloud2"] = got.append
        rng = np.random.default_rng(0)
        n = 200
        xyz = np.column_stack(
            [rng.uniform(-1.5, 1.5, (n, 2)), rng.normal(-0.5, 0.05, (n, 1))]
        ).astype(np.float32)
        from fastdem_tpu.cloud.pointcloud import from_numpy

        assert drv.on_scan(from_numpy(xyz), np.eye(4), np.eye(4))
        drv._viz_loop()
        drv.close()
        assert len(got) == 1
        msg = got[0]
        assert isinstance(msg, PointCloud2)
        assert msg.width > 0
        assert [f.name for f in msg.fields][:3] == ["x", "y", "z"]
        assert len(msg.data) == msg.width * msg.point_step


def test_node_live_viewer_and_launcher(tmp_path):
    """run_launch.py (the run.launch.py behavioral equivalent) picks the
    preset, forwards passthrough args, and --viz serves the live viewer
    while the node maps."""
    import os
    import subprocess
    import sys

    out = str(tmp_path / "out")
    r = subprocess.run(
        [
            sys.executable, "tools/run_launch.py", "--viz",
            "--synthetic", "3", "--out", out, "--platform", "cpu",
        ],
        capture_output=True, text=True, cwd=REPO, timeout=400,
        env=dict(os.environ),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "local_mapping.yaml" in r.stderr  # preset selection
    assert "live viewer: http://127.0.0.1:" in r.stderr
    assert "integrated 3 scans" in r.stdout
    assert os.path.exists(f"{out}/map_final.npz")
