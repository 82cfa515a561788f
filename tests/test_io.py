"""IO tests (mirrors reference tests/test_map_io.cpp: npz round trips incl.
internal estimator layers, selective save, future-version rejection, PNG
colormaps/normalization; plus PCD/KITTI/trajectory round trips)."""

import json
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest

from fastdem_tpu.cloud import pointcloud as pc
from fastdem_tpu.grid import gridmap
from fastdem_tpu.grid.geometry import GridGeometry
from fastdem_tpu.grid.gridmap import GridMapState, layers
from fastdem_tpu.io import npz as npz_io
from fastdem_tpu.io import pcd as pcd_io
from fastdem_tpu.io import png as png_io


def demo_state(rng):
    geom = GridGeometry.from_length(2.0, 3.0, 0.5)  # 4 x 6
    fills = gridmap.default_layer_fills()
    fills["_kalman_p"] = 0.0
    state = gridmap.create(geom, fills, position=(1.25, -0.75))
    elev = rng.normal(size=geom.shape).astype(np.float32)
    elev[0, 0] = np.nan
    state = state.replace_layer(layers.elevation, jnp.asarray(elev))
    return geom, state


class TestNpz:
    def test_round_trip(self, rng, tmp_path):
        geom, state = demo_state(rng)
        path = str(tmp_path / "map.npz")
        assert npz_io.save_npz(path, geom, state, frame_id="odom")
        geom2, state2, meta = npz_io.load_npz(path)
        assert geom2 == geom
        assert meta["frame_id"] == "odom"
        np.testing.assert_allclose(
            np.asarray(state2.position), np.asarray(state.position)
        )
        for name in state.layers:
            np.testing.assert_array_equal(
                np.asarray(state2.layers[name]), np.asarray(state.layers[name])
            )

    def test_selective_save(self, rng, tmp_path):
        geom, state = demo_state(rng)
        path = str(tmp_path / "sel.npz")
        npz_io.save_npz(path, geom, state, layer_names=[layers.elevation])
        _, state2, _ = npz_io.load_npz(path)
        assert set(state2.layers) == {layers.elevation}

    def test_missing_layer_skipped(self, rng, tmp_path):
        geom, state = demo_state(rng)
        path = str(tmp_path / "m.npz")
        assert npz_io.save_npz(
            path, geom, state, layer_names=[layers.elevation, "nope"]
        )
        _, state2, _ = npz_io.load_npz(path)
        assert "nope" not in state2.layers

    def test_future_version_rejected(self, rng, tmp_path):
        geom, state = demo_state(rng)
        path = str(tmp_path / "v.npz")
        npz_io.save_npz(path, geom, state)
        # Tamper the meta version.
        with np.load(path) as data:
            arrays = {n: data[n] for n in data.files if n != "meta"}
            meta = json.loads(bytes(data["meta"].item()).decode())
        meta["version"] = 99
        with open(path, "wb") as f:
            np.savez(f, **arrays, meta=np.bytes_(json.dumps(meta).encode()))
        with pytest.raises(ValueError, match="version"):
            npz_io.load_npz(path)

    def test_invalid_path(self, rng):
        geom, state = demo_state(rng)
        assert not npz_io.save_npz("/nonexistent_dir/x.npz", geom, state)

    def test_numpy_interop_fortran_f4(self, rng, tmp_path):
        """Layers must be Fortran-order float32 like the reference writer
        (io_npz.cpp:141-146) so files cross-load bit-exactly."""
        geom, state = demo_state(rng)
        path = str(tmp_path / "f.npz")
        npz_io.save_npz(path, geom, state)
        with zipfile.ZipFile(path) as z:
            with z.open("elevation.npy") as f:
                head = f.read(80)
        assert b"'fortran_order': True" in head
        assert b"<f4" in head

    def test_start_index_unroll(self, rng, tmp_path):
        """A reference-produced file with a rotated circular buffer loads
        world-aligned."""
        geom, state = demo_state(rng)
        path = str(tmp_path / "s.npz")
        npz_io.save_npz(path, geom, state)
        with np.load(path) as data:
            arrays = {n: data[n] for n in data.files if n != "meta"}
            meta = json.loads(bytes(data["meta"].item()).decode())
        # Simulate reference rotation: buffer = roll(world, +start).
        start = (1, 2)
        meta["start_index"] = list(start)
        arrays = {
            n: np.roll(a, shift=start, axis=(0, 1)) for n, a in arrays.items()
        }
        with open(path, "wb") as f:
            np.savez(f, **arrays, meta=np.bytes_(json.dumps(meta).encode()))
        _, state2, _ = npz_io.load_npz(path)
        np.testing.assert_array_equal(
            np.asarray(state2.layers[layers.elevation]),
            np.asarray(state.layers[layers.elevation]),
        )


class TestPng:
    def test_writes_valid_png(self, rng, tmp_path):
        geom, state = demo_state(rng)
        path = str(tmp_path / "m.png")
        assert png_io.save_png(path, state, layers.elevation)
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"

    def test_nan_is_transparent(self, rng):
        layer = np.array([[1.0, np.nan], [0.0, 0.5]], dtype=np.float32)
        rgba = png_io.layer_to_rgba(layer)
        assert rgba[0, 1, 3] == 0
        assert rgba[0, 0, 3] == 255

    def test_colormaps(self, rng):
        layer = np.linspace(0, 1, 16, dtype=np.float32).reshape(4, 4)
        for cm in png_io.Colormap:
            rgba = png_io.layer_to_rgba(
                layer, png_io.PngExportConfig(colormap=cm)
            )
            assert rgba.shape == (4, 4, 4)

    def test_fixed_range(self):
        layer = np.array([[0.0, 10.0]], dtype=np.float32)
        cfg = png_io.PngExportConfig(
            normalize=png_io.Normalize.FIXED_RANGE, fixed_min=0, fixed_max=20
        )
        rgba = png_io.layer_to_rgba(layer, cfg)
        # 10 of 20 -> mid gray under grayscale.
        cfg.colormap = png_io.Colormap.GRAYSCALE
        rgba = png_io.layer_to_rgba(layer, cfg)
        assert abs(int(rgba[0, 1, 0]) - 128) <= 1

    def test_missing_layer(self, rng, tmp_path):
        geom, state = demo_state(rng)
        assert not png_io.save_png(str(tmp_path / "x.png"), state, "nope")


class TestPcd:
    def test_binary_round_trip(self, rng, tmp_path):
        xyz = rng.normal(size=(20, 3)).astype(np.float32)
        inten = rng.uniform(size=20).astype(np.float32)
        cloud = pc.from_numpy(xyz, intensity=inten)
        path = str(tmp_path / "c.pcd")
        assert pcd_io.save_pcd(path, cloud, binary=True)
        back = pcd_io.load_pcd(path)
        np.testing.assert_allclose(np.asarray(back.xyz), xyz, atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(back.channels["intensity"]), inten, atol=1e-6
        )

    def test_ascii_round_trip(self, rng, tmp_path):
        xyz = rng.normal(size=(10, 3)).astype(np.float32)
        cloud = pc.from_numpy(xyz)
        path = str(tmp_path / "a.pcd")
        assert pcd_io.save_pcd(path, cloud, binary=False)
        back = pcd_io.load_pcd(path)
        np.testing.assert_allclose(np.asarray(back.xyz), xyz, atol=1e-5)

    def test_color_round_trip(self, rng, tmp_path):
        xyz = np.zeros((3, 3), dtype=np.float32)
        color = rng.integers(0, 256, size=(3, 3)).astype(np.uint8)
        cloud = pc.from_numpy(xyz, color=color)
        path = str(tmp_path / "rgb.pcd")
        pcd_io.save_pcd(path, cloud)
        back = pcd_io.load_pcd(path)
        np.testing.assert_array_equal(
            np.asarray(back.channels["color"]), color
        )

    def test_masked_points_dropped(self, rng, tmp_path):
        cloud = pc.from_numpy(np.zeros((4, 3), np.float32))
        cloud = cloud.with_mask(jnp.array([True, False, True, False]))
        path = str(tmp_path / "m.pcd")
        pcd_io.save_pcd(path, cloud)
        back = pcd_io.load_pcd(path)
        assert back.capacity == 2


class TestKittiTrajectory:
    def test_bin_round_trip(self, rng, tmp_path):
        xyz = rng.normal(size=(15, 3)).astype(np.float32)
        inten = rng.uniform(size=15).astype(np.float32)
        cloud = pc.from_numpy(xyz, intensity=inten)
        path = str(tmp_path / "v.bin")
        assert pcd_io.save_kitti_bin(path, cloud)
        back = pcd_io.load_kitti_bin(path)
        np.testing.assert_allclose(np.asarray(back.xyz), xyz)

    def test_tum_round_trip(self, tmp_path):
        from fastdem_tpu.cloud import transform as tfm

        T = np.asarray(tfm.from_rpy(0.1, 0.2, 0.3, t=[1, 2, 3]))
        path = str(tmp_path / "traj.txt")
        assert pcd_io.save_trajectory_tum(path, [1.5], [T])
        ts, poses = pcd_io.load_trajectory_tum(path)
        assert ts[0] == pytest.approx(1.5)
        np.testing.assert_allclose(poses[0], T, atol=1e-5)

    def test_kitti_poses(self, tmp_path):
        path = str(tmp_path / "poses.txt")
        T = np.eye(4)[:3].reshape(-1)
        np.savetxt(path, T[None])
        poses = pcd_io.load_trajectory_kitti(path)
        np.testing.assert_allclose(poses[0], np.eye(4))


class TestNativeIO:
    """Native C++ IO parity with the pure-Python implementations."""

    def test_native_available(self):
        from fastdem_tpu import native

        # The image ships g++; the native path must build here.
        assert native.available()

    def test_native_python_parity_binary(self, rng, tmp_path):
        xyz = rng.normal(size=(500, 3)).astype(np.float32)
        inten = rng.uniform(size=500).astype(np.float32)
        color = rng.integers(0, 256, size=(500, 3)).astype(np.uint8)
        cloud = pc.from_numpy(xyz, intensity=inten, color=color)
        p_native = str(tmp_path / "n.pcd")
        p_python = str(tmp_path / "p.pcd")
        assert pcd_io.save_pcd(p_native, cloud, use_native=True)
        assert pcd_io.save_pcd(p_python, cloud, use_native=False)
        a = pcd_io.load_pcd(p_native, use_native=True)
        b = pcd_io.load_pcd(p_python, use_native=False)
        np.testing.assert_allclose(np.asarray(a.xyz), np.asarray(b.xyz))
        np.testing.assert_allclose(
            np.asarray(a.channels["intensity"]),
            np.asarray(b.channels["intensity"]),
        )
        np.testing.assert_array_equal(
            np.asarray(a.channels["color"]), np.asarray(b.channels["color"])
        )

    def test_native_reads_python_ascii(self, rng, tmp_path):
        xyz = rng.normal(size=(50, 3)).astype(np.float32)
        cloud = pc.from_numpy(xyz)
        path = str(tmp_path / "a.pcd")
        pcd_io.save_pcd(path, cloud, binary=False)
        back = pcd_io.load_pcd(path, use_native=True)
        np.testing.assert_allclose(np.asarray(back.xyz), xyz, atol=1e-5)

    def test_native_kitti(self, rng, tmp_path):
        xyz = rng.normal(size=(100, 3)).astype(np.float32)
        inten = rng.uniform(size=100).astype(np.float32)
        cloud = pc.from_numpy(xyz, intensity=inten)
        path = str(tmp_path / "k.bin")
        pcd_io.save_kitti_bin(path, cloud)
        back = pcd_io.load_kitti_bin(path, use_native=True)
        np.testing.assert_allclose(np.asarray(back.xyz), xyz)
        np.testing.assert_allclose(
            np.asarray(back.channels["intensity"]), inten
        )


class TestHtmlViewer:
    def test_save_html_self_contained(self, tmp_path):
        """The Rerun-equivalent viz artifact: one dependency-free HTML file
        embedding the quantized elevation surface (io/html_viewer.py)."""
        import fastdem_tpu as fd
        from fastdem_tpu.io.html_viewer import save_html

        geom = fd.GridGeometry.from_length(4.0, 4.0, 0.5)
        m = fd.FastDEM(geom, fd.Config())
        rng = np.random.default_rng(0)
        xyz = np.column_stack(
            [rng.uniform(-1.8, 1.8, (300, 2)),
             rng.normal(-0.5, 0.1, (300, 1))]
        ).astype(np.float32)
        from fastdem_tpu.cloud.pointcloud import from_numpy

        assert m.integrate(from_numpy(xyz), np.eye(4), np.eye(4))
        out = tmp_path / "map.html"
        assert save_html(str(out), geom, m.state)
        html = out.read_text()
        assert "<html>" in html and "</html>" in html
        assert "http" not in html.lower().replace(
            "charcodeat", ""
        )  # no external resources
        assert '"rows": 8' in html
        # Quantized payload decodes to the right cell count.
        import base64 as b64
        import re

        blob = re.search(r'decodeFrame\(\{.*?\}, "([A-Za-z0-9+/=]+)"\)', html).group(1)
        raw = b64.b64decode(blob)
        assert len(raw) == 2 * 8 * 8
        # Decode exactly like the embedded JS (u16 LE, 65535 = NaN,
        # linear dequantization) and compare against the map layer.
        import json as _json

        meta = _json.loads(
            re.search(r"decodeFrame\((\{.*?\}), ", html).group(1)
        )
        q = np.frombuffer(raw, dtype="<u2").astype(np.float64)
        dec = np.where(
            q == 65535, np.nan,
            meta["zmin"] + q / 65534.0 * (meta["zmax"] - meta["zmin"]),
        ).reshape(8, 8)
        elev = np.asarray(m.state.layers["elevation"])
        np.testing.assert_array_equal(np.isnan(dec), np.isnan(elev))
        fin = np.isfinite(elev)
        if fin.any():
            span = meta["zmax"] - meta["zmin"]
            assert np.abs(dec[fin] - elev[fin]).max() <= span / 65534 + 1e-9

    def test_downsampling_respects_max_cells(self, tmp_path):
        import fastdem_tpu as fd
        from fastdem_tpu.io.html_viewer import save_html
        from fastdem_tpu.mapping.pipeline import create_map_state

        geom = fd.GridGeometry.from_length(100.0, 100.0, 0.1)  # 1M cells
        state = create_map_state(geom, fd.Config())
        out = tmp_path / "big.html"
        assert save_html(str(out), geom, state, max_cells=40_000)
        import json as _json
        import re

        meta = _json.loads(
            re.search(r"decodeFrame\((\{.*?\}), ", out.read_text()).group(1)
        )
        assert meta["rows"] * meta["cols"] <= 40_000


def test_viewpoint_numpy_array_roundtrip(tmp_path):
    """Regression: save_pcd(viewpoint=<numpy array>) crashed in the pure-
    Python writer ('truth value of an array is ambiguous') — the exact
    type load_pcd(return_meta=True) returns."""
    import numpy as np

    from fastdem_tpu.cloud.pointcloud import from_numpy
    from fastdem_tpu.io.pcd import load_pcd, save_pcd

    xyz = np.arange(12, dtype=np.float32).reshape(4, 3)
    vp = (1.0, 2.0, 3.0, 1.0, 0.0, 0.0, 0.0)
    p1 = str(tmp_path / "a.pcd")
    assert save_pcd(p1, from_numpy(xyz), viewpoint=vp, use_native=False)
    _, meta = load_pcd(p1, return_meta=True)
    assert isinstance(meta["viewpoint"], np.ndarray)
    p2 = str(tmp_path / "b.pcd")
    assert save_pcd(
        p2, from_numpy(xyz), viewpoint=meta["viewpoint"], use_native=False,
        binary=False,
    )
    _, meta2 = load_pcd(p2, return_meta=True)
    np.testing.assert_allclose(meta2["viewpoint"], vp)


class TestLiveViewer:
    """Live HTTP streaming viewer (io/live_viewer.py) — the Rerun-bridge
    live-inspection capability with stdlib-only parts."""

    def _mapper(self):
        import fastdem_tpu as fd
        from fastdem_tpu.cloud.pointcloud import from_numpy

        geom = fd.GridGeometry.from_length(4.0, 4.0, 0.5)
        m = fd.FastDEM(geom, fd.Config())
        rng = np.random.default_rng(0)
        xyz = np.column_stack(
            [rng.uniform(-1.8, 1.8, (300, 2)),
             rng.normal(-0.5, 0.1, (300, 1))]
        ).astype(np.float32)
        assert m.integrate(from_numpy(xyz), np.eye(4), np.eye(4))
        return geom, m

    def test_serves_page_and_frames(self):
        import base64 as b64
        import json as _json
        import urllib.request

        from fastdem_tpu.io.live_viewer import LiveViewer

        geom, m = self._mapper()
        lv = LiveViewer(port=0).start()  # free port
        try:
            seq = lv.publish(geom, m.state)
            page = urllib.request.urlopen(lv.url, timeout=10).read().decode()
            assert "decodeFrame" in page and "/frame?seq=" in page

            f = _json.loads(
                urllib.request.urlopen(
                    lv.url + "frame", timeout=10
                ).read()
            )
            assert f["seq"] == seq
            meta = f["meta"]
            q = np.frombuffer(
                b64.b64decode(f["z"]), dtype="<u2"
            ).astype(np.float64)
            dec = np.where(
                q == 65535, np.nan,
                meta["zmin"] + q / 65534.0 * (meta["zmax"] - meta["zmin"]),
            ).reshape(meta["rows"], meta["cols"])
            elev = np.asarray(m.state.layers["elevation"])
            np.testing.assert_array_equal(np.isnan(dec), np.isnan(elev))
            fin = np.isfinite(elev)
            span = meta["zmax"] - meta["zmin"]
            assert np.abs(dec[fin] - elev[fin]).max() <= span / 65534 + 1e-9

            # Sequence gating: a client that already has seq gets no body.
            f2 = _json.loads(
                urllib.request.urlopen(
                    lv.url + f"frame?seq={seq}", timeout=10
                ).read()
            )
            assert f2 == {"seq": seq}

            # A new publish bumps the sequence.
            seq2 = lv.publish(geom, m.state)
            assert seq2 == seq + 1
            f3 = _json.loads(
                urllib.request.urlopen(
                    lv.url + f"frame?seq={seq}", timeout=10
                ).read()
            )
            assert f3["seq"] == seq2 and "meta" in f3
        finally:
            lv.stop()

    def test_driver_sink_adapter(self):
        from fastdem_tpu.io.live_viewer import LiveViewer

        geom, m = self._mapper()
        lv = LiveViewer(port=0).start()
        try:
            cb = lv.sink(geom)
            cb({
                "layers": {
                    k: np.asarray(v) for k, v in m.state.layers.items()
                },
                "position": np.zeros(2),
                "scan_count": 1,
            })
            assert lv._seq == 1
        finally:
            lv.stop()

    def test_scan_points_in_frame(self):
        """3D point view: the frame carries the last scan
        as quantized viewer-frame points, decodable within quantization
        tolerance — the Rerun-bridge point inspection capability."""
        import base64 as b64
        import json as _json
        import urllib.request

        from fastdem_tpu.io.live_viewer import LiveViewer

        geom, m = self._mapper()
        rng = np.random.default_rng(1)
        scan = np.column_stack(
            [rng.uniform(-1.5, 1.5, (200, 2)),
             rng.normal(-0.5, 0.1, (200, 1))]
        ).astype(np.float32)
        lv = LiveViewer(port=0).start()
        try:
            lv.publish(geom, m.state, scan_xyz=scan)
            f = _json.loads(
                urllib.request.urlopen(lv.url + "frame", timeout=10).read()
            )
            pmeta = f["meta"]["pts"]
            assert pmeta["n"] == 200
            q = np.frombuffer(
                b64.b64decode(f["p"]), dtype="<u2"
            ).astype(np.float64).reshape(-1, 3)
            lo = np.asarray(pmeta["lo"])
            hi = np.asarray(pmeta["hi"])
            dec = lo + q / 65535.0 * (hi - lo)
            # Viewer frame: vx = px - wx - res/2 (row -> -x convention).
            pos = np.asarray(m.state.position)
            expect = np.stack(
                [
                    pos[0] - scan[:, 0] - geom.resolution / 2,
                    pos[1] - scan[:, 1] - geom.resolution / 2,
                    scan[:, 2],
                ],
                axis=1,
            )
            tol = (hi - lo) / 65535 + 1e-6
            assert np.all(np.abs(dec - expect) <= tol)
            # Without scan points the frame omits the point payload.
            lv.publish(geom, m.state)
            f2 = _json.loads(
                urllib.request.urlopen(lv.url + "frame", timeout=10).read()
            )
            assert "p" not in f2 and "pts" not in f2["meta"]
        finally:
            lv.stop()
