"""TRUE golden tests: fastdem_tpu vs the COMPILED C++ reference.

The reference's grid dependency (nanoGrid) is fetched from GitHub at build
time and unavailable here, so tests/refbuild/ provides an API-compatibility
layer written from the call-site contract (SURVEY.md 2.3), a spdlog shim,
and a generator main. This suite compiles the reference sources IN PLACE
from /root/reference (never copied) against those shims, feeds both
implementations identical scan/pose streams, and compares every map layer.

Measured agreement (also asserted below; summary table in PARITY.md):
  * Kalman + Welford, min/max/obstacle/count layers: float-ULP level
    (many layers bit-exact; the reference computes transforms in double).
  * P2 quantile estimator: BIT-EXACT on all marker/count/bound layers.
  * Postprocess chain (UF + inpaint + features): 1e-6-level (slope in
    degrees to 3e-3 via acos sensitivity).
  * Raycasting: the documented polar-vs-DDA deviation envelope
    (PARITY.md); multi-frame ghost clearing removes the SAME cells.
  * RGB-D/Constant sensor models: within 1e-5 (isolated cell-boundary
    points excepted); intensity max-pool exact.
  * Offline buildDEM: support within 1%, elevation p99 <= 1e-4.
  * Interop: npz round trip through the reference parser bit-exact; PNG
    renders pixel-identical; .pcd files parse through nanoPCL.

Skipped when no C++ toolchain or vendored Eigen is available.
"""

import os
import struct
import subprocess
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from fastdem_tpu import Config, GridGeometry
from fastdem_tpu.config.config import EstimationType, MappingMode, PostProcessConfig
from fastdem_tpu.io.npz import load_npz
from fastdem_tpu.mapping.pipeline import build_integrate, create_map_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFBUILD = os.path.join(REPO, "tests", "refbuild")
REF = "/root/reference/fastdem"
TF_INC = "/opt/venv/lib/python3.12/site-packages/tensorflow/include"

REF_SOURCES = [
    "fastdem.cpp", "elevation_mapping.cpp", "sensor_model.cpp",
    "raycasting.cpp", "inpainting.cpp", "uncertainty_fusion.cpp",
    "feature_extraction.cpp", "io_npz.cpp", "pcd_convert.cpp",
    "io_png.cpp",
]


@pytest.fixture(scope="module")
def golden_gen(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    if not os.path.isdir(os.path.join(TF_INC, "Eigen")):
        pytest.skip("no vendored Eigen")
    if not os.path.isdir(REF):
        pytest.skip("reference not mounted")
    out = tmp_path_factory.mktemp("refbuild") / "golden_gen"
    cmd = [
        "g++", "-O2", "-std=c++17",
        "-I", REFBUILD,
        "-I", os.path.join(REF, "include"),
        "-I", os.path.join(REF, "lib", "nanoPCL", "include"),
        "-I", os.path.join(REF, "lib", "nanoPCL", "thirdparty"),
        "-I", os.path.join(REF, "lib", "stb"),
        "-I", TF_INC,
        os.path.join(REFBUILD, "golden_gen.cpp"),
        *[os.path.join(REF, "src", s) for s in REF_SOURCES],
        "-o", str(out),
    ]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        pytest.skip(f"reference build failed: {r.stderr[-800:]}")
    return str(out)


def make_stream(seed=7, K=6, N=8000, step_x=0.3):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, (K, N)).astype(np.float32)
    rad = rng.uniform(0.5, 6.0, (K, N)).astype(np.float32)
    x = rad * np.cos(ang)
    y = rad * np.sin(ang)
    z = (
        0.2 * np.sin(0.7 * x) * np.cos(0.5 * y)
        - 1.0
        + rng.normal(0, 0.02, (K, N))
    ).astype(np.float32)
    xyz = np.stack([x, y, z], -1).astype(np.float32)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, 0, 3] = step_x * np.arange(K)
    return xyz, T_bs, poses


def run_reference(golden_gen, tmp, xyz, T_bs, poses, est, raycast, mode,
                  pp=0, sensor="lidar", intensity=None, color=None,
                  size=(15.0, 15.0)):
    K, N = xyz.shape[:2]
    data = xyz
    if intensity is not None:
        data = np.concatenate([data, intensity[..., None]], axis=-1)
    if color is not None:  # [K, N, 3] u8-valued floats
        data = np.concatenate([data, color.astype(np.float32)], axis=-1)
    with open(tmp / "scans.bin", "wb") as f:
        f.write(struct.pack("<ii", K, N))
        f.write(np.ascontiguousarray(data, np.float32).tobytes())
    with open(tmp / "poses.bin", "wb") as f:
        f.write(T_bs.tobytes())
        f.write(poses.tobytes())
    out = tmp / "ref.npz"
    r = subprocess.run(
        [golden_gen, str(tmp / "scans.bin"), str(tmp / "poses.bin"),
         str(out), est, str(raycast), mode, str(size[0]), str(size[1]),
         "0.1", str(pp),
         sensor, "1" if intensity is not None else "0",
         "1" if color is not None else "0"],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    _, sref, _ = load_npz(str(out))
    return sref


def run_ours(xyz, T_bs, poses, est, raycast, mode, sensor="lidar",
            intensity=None):
    from fastdem_tpu.config.config import SensorType

    cfg = Config()
    if est == "p2":
        cfg.mapping.estimation_type = EstimationType.P2_QUANTILE
    if mode == "global":
        cfg.mapping.mode = MappingMode.GLOBAL
    cfg.raycasting.enabled = bool(raycast)
    if sensor == "rgbd":
        cfg.sensor_model.type = SensorType.RGBD
    elif sensor == "constant":
        cfg.sensor_model.type = SensorType.CONSTANT
    geom = GridGeometry.from_length(15.0, 15.0, 0.1)
    step = build_integrate(
        geom, cfg, has_intensity=intensity is not None, donate=False
    )
    state = create_map_state(
        geom, cfg, has_intensity=intensity is not None
    )
    K, N = xyz.shape[:2]
    for k in range(K):
        state, _ = step(
            state, jnp.asarray(xyz[k]), jnp.ones(N, bool),
            jnp.asarray(T_bs), jnp.asarray(poses[k]),
            jnp.asarray(intensity[k]) if intensity is not None else None,
        )
    return geom, state


def assert_layer(a, b, name, atol, nan_budget=0):
    nan_mis = int((np.isnan(a) != np.isnan(b)).sum())
    assert nan_mis <= nan_budget, f"{name}: {nan_mis} nan mismatches"
    both = np.isfinite(a) & np.isfinite(b)
    assert both.any(), f"{name}: no overlap"
    md = float(np.abs(a[both] - b[both]).max())
    assert md <= atol, f"{name}: maxdiff {md} > {atol}"


def test_kalman_local_matches_reference(golden_gen, tmp_path):
    xyz, T_bs, poses = make_stream()
    sref = run_reference(golden_gen, tmp_path, xyz, T_bs, poses,
                         "kalman", 0, "local")
    _, state = run_ours(xyz, T_bs, poses, "kalman", 0, "local")
    exact = ("elevation_min", "elevation_max", "n_points", "obstacle",
             "_sample_mean")
    for name in sref.layers:
        a = np.asarray(sref.layers[name])
        b = np.asarray(state.layers[name])
        assert_layer(a, b, name, 0.0 if name in exact else 1e-6)


def test_long_trajectory_full_buffer_rotation(golden_gen, tmp_path):
    """SURVEY.md 'hard parts': circular-buffer wrap math under sustained
    LOCAL motion. 60 scans x 0.43 m traverse ~26 m over a 15 m window, so
    the reference's start index fully rotates (and wraps negative-mod)
    multiple times while our world-aligned roll does the equivalent; the
    final maps must still agree at float-ULP level.

    (Half-cell ties are matched too since gridmap.round_half_away
    reproduces std::round's half-away semantics — see
    test_half_cell_trajectory_matches_reference below.)"""
    xyz, T_bs, poses = make_stream(seed=21, K=60, N=4000, step_x=0.43)
    sref = run_reference(golden_gen, tmp_path, xyz, T_bs, poses,
                         "kalman", 0, "local")
    _, state = run_ours(xyz, T_bs, poses, "kalman", 0, "local")
    np.testing.assert_allclose(
        np.asarray(sref.position), np.asarray(state.position), atol=1e-4
    )
    for name in sref.layers:
        a = np.asarray(sref.layers[name])
        b = np.asarray(state.layers[name])
        # A handful of cell-boundary points classify differently over
        # 240K f32-vs-double transforms (observed: 8); all else exact-ish.
        assert int((np.isnan(a) != np.isnan(b)).sum()) <= 12, name
        both = np.isfinite(a) & np.isfinite(b)
        bad = int((np.abs(a[both] - b[both]) > 1e-5).sum())
        assert bad <= 12, f"{name}: {bad} cells differ"


def test_half_cell_trajectory_matches_reference(golden_gen, tmp_path):
    """LOCAL moves at EXACT half-cell robot steps.

    step_x = 0.05 with res 0.1: float(0.05) is exactly float(0.1)/2, so
    every other move quotient is an exact f32 tie at k + 0.5.  jnp.round
    (half-even) walked the lattice one cell differently from the
    reference's std::round (half-away; refbuild/nanogrid/nanogrid.hpp:209
    mirroring src/elevation_mapping.cpp move semantics) — fixed by
    gridmap.round_half_away.  The two lattice walks, and hence map
    positions and all layers, must now agree on the tie path too."""
    xyz, T_bs, poses = make_stream(seed=33, K=24, N=3000, step_x=0.05)
    sref = run_reference(golden_gen, tmp_path, xyz, T_bs, poses,
                         "kalman", 0, "local")
    _, state = run_ours(xyz, T_bs, poses, "kalman", 0, "local")
    np.testing.assert_allclose(
        np.asarray(sref.position), np.asarray(state.position), atol=1e-6
    )
    for name in sref.layers:
        a = np.asarray(sref.layers[name])
        b = np.asarray(state.layers[name])
        assert int((np.isnan(a) != np.isnan(b)).sum()) <= 6, name
        both = np.isfinite(a) & np.isfinite(b)
        bad = int((np.abs(a[both] - b[both]) > 1e-5).sum())
        assert bad <= 6, f"{name}: {bad} cells differ"


def test_kalman_twophase_scatter_matches_reference(golden_gen, tmp_path):
    """The two-phase f32 scatter mode against the reference.

    At this stream length one point sits exactly on a cell boundary and
    lands one cell over vs the reference's double-precision transforms
    (same class as the sensor-model tests; verified identical between
    our packed and twophase modes, so it is not a tie-semantics effect
    — packed's smallest-index tie-break happens to coincide with the
    reference's first-seen rule for exact ties anyway). Allow isolated
    boundary cells; everything else must match to 1e-6."""
    xyz, T_bs, poses = make_stream(K=4)
    sref = run_reference(golden_gen, tmp_path, xyz, T_bs, poses,
                         "kalman", 0, "local")
    cfg = Config()
    geom = GridGeometry.from_length(15.0, 15.0, 0.1)
    step = build_integrate(geom, cfg, donate=False, scatter_mode="twophase")
    state = create_map_state(geom, cfg)
    for k in range(4):
        state, _ = step(
            state, jnp.asarray(xyz[k]), jnp.ones(xyz.shape[1], bool),
            jnp.asarray(T_bs), jnp.asarray(poses[k]),
        )
    for name in sref.layers:
        a = np.asarray(sref.layers[name])
        b = np.asarray(state.layers[name])
        assert int((np.isnan(a) != np.isnan(b)).sum()) <= 3, name
        both = np.isfinite(a) & np.isfinite(b)
        bad = int((np.abs(a[both] - b[both]) > 1e-6).sum())
        assert bad <= 3, f"{name}: {bad} cells beyond boundary tolerance"


def test_p2_local_bitexact_vs_reference(golden_gen, tmp_path):
    """The branchless vectorized P2 reproduces the reference's marker
    algorithm BIT-FOR-BIT on every layer."""
    xyz, T_bs, poses = make_stream()
    sref = run_reference(golden_gen, tmp_path, xyz, T_bs, poses,
                         "p2", 0, "local")
    _, state = run_ours(xyz, T_bs, poses, "p2", 0, "local")
    for name in sref.layers:
        np.testing.assert_array_equal(
            np.asarray(sref.layers[name]),
            np.asarray(state.layers[name]),
            err_msg=name,
        )


def test_windowed_global_matches_reference(golden_gen, tmp_path):
    """Window-local updates vs the reference on a GLOBAL map where the
    window engages (40x40 m map, 8 m range bound -> ~216-cell window).

    The reference has no range filter here; 8 m exceeds every synthetic
    point's base-frame distance (rad <= 6 m, |z_base| <~ 2.5 m), so the
    filter drops nothing and the layer-by-layer comparison isolates the
    windowed dynamic-slice/update/write-back machinery. Tolerances mirror
    the raycast envelope golden (the polar-vs-DDA deviation is the same
    documented envelope; the windowing itself is exact —
    tests/test_window_update.py)."""
    from fastdem_tpu.mapping import pipeline as pl

    xyz, T_bs, poses = make_stream()
    sref = run_reference(golden_gen, tmp_path, xyz, T_bs, poses,
                         "kalman", 1, "global", size=(40.0, 40.0))

    cfg = Config()
    cfg.mapping.mode = MappingMode.GLOBAL
    cfg.raycasting.enabled = True
    cfg.point_filter.range_max = 8.0
    geom = GridGeometry.from_length(40.0, 40.0, 0.1)
    # The window must actually engage for this test to mean anything.
    _, _, _, pab = pl._build_phases(geom, cfg, None, None, None, "rows", None)
    assert pab is None, "expected the windowed path (batched harness off)"
    step = build_integrate(geom, cfg, donate=False)
    state = create_map_state(geom, cfg)
    K, N = xyz.shape[:2]
    for k in range(K):
        state, _ = step(
            state, jnp.asarray(xyz[k]), jnp.ones(N, bool),
            jnp.asarray(T_bs), jnp.asarray(poses[k]),
        )

    ncell = geom.num_cells
    for name in sref.layers:
        a = np.asarray(sref.layers[name])
        b = np.asarray(state.layers[name])
        if name == "raycasting":
            nan_mis = int((np.isnan(a) != np.isnan(b)).sum())
            assert nan_mis <= ncell * 0.02, name
            both = np.isfinite(a) & np.isfinite(b)
            p99 = float(np.percentile(np.abs(a[both] - b[both]), 99))
            assert p99 < 0.12, f"raycasting p99 {p99}"
        elif name == "_visibility_logodds":
            both = np.isfinite(a) & np.isfinite(b)
            diff = np.abs(a[both] - b[both])
            touched = max(int(both.sum()), 1)
            assert (diff > 1e-5).sum() / touched < 0.05, name
            assert float(diff.max()) <= 1.0, name
        elif name == "ghost_removal":
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                          err_msg=name)
        else:
            assert_layer(a, b, name, 1e-6, nan_budget=int(ncell * 0.005))


def test_raycast_matches_reference_within_envelope(golden_gen, tmp_path):
    xyz, T_bs, poses = make_stream()
    sref = run_reference(golden_gen, tmp_path, xyz, T_bs, poses,
                         "kalman", 1, "local")
    _, state = run_ours(xyz, T_bs, poses, "kalman", 1, "local")
    ncell = np.asarray(sref.layers["elevation"]).size
    for name in sref.layers:
        a = np.asarray(sref.layers[name])
        b = np.asarray(state.layers[name])
        if name == "raycasting":
            # polar reformulation vs DDA: documented deviation envelope
            nan_mis = int((np.isnan(a) != np.isnan(b)).sum())
            assert nan_mis <= ncell * 0.02, name
            both = np.isfinite(a) & np.isfinite(b)
            p99 = float(np.percentile(np.abs(a[both] - b[both]), 99))
            assert p99 < 0.12, f"raycasting p99 {p99}"
        elif name == "_visibility_logodds":
            both = np.isfinite(a) & np.isfinite(b)
            diff = np.abs(a[both] - b[both])
            # quantized evidence steps on a small fraction of cells (r2
            # acceptance: <5% at the accuracy defaults, was <25% in r1;
            # residual = the documented all-rays refinement + bin-level
            # ray selection)
            assert (diff > 1e-5).mean() < 0.05, name
            assert float(diff.max()) <= 1.0, name
        elif name == "ghost_removal":
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                          err_msg=name)
        else:
            assert_layer(a, b, name, 1e-6, nan_budget=int(ncell * 0.005))


@pytest.mark.parametrize("sensor", ["rgbd", "constant"])
def test_sensor_models_match_reference(golden_gen, tmp_path, sensor):
    """The fused z-variance hot path (r3^T Sigma r3, never materializing
    [N,3,3]) must agree with the reference's full covariance pipeline for
    every sensor model — visible through the variance/bound layers.

    The reference transforms points in double; at exact cell boundaries an
    f32-transformed point can land one cell over (observed: 1 point of
    32K), so a handful of isolated boundary cells are tolerated."""
    xyz, T_bs, poses = make_stream(K=4)
    sref = run_reference(golden_gen, tmp_path, xyz, T_bs, poses,
                         "kalman", 0, "local", sensor=sensor)
    _, state = run_ours(xyz, T_bs, poses, "kalman", 0, "local", sensor=sensor)
    for name in ("elevation", "variance", "_kalman_p", "upper_bound",
                 "lower_bound", "n_points"):
        a = np.asarray(sref.layers[name])
        b = np.asarray(state.layers[name])
        assert int((np.isnan(a) != np.isnan(b)).sum()) <= 3, name
        both = np.isfinite(a) & np.isfinite(b)
        bad = int((np.abs(a[both] - b[both]) > 1e-5).sum())
        assert bad <= 3, f"{name}: {bad} cells differ beyond 1e-5"


def test_intensity_channel_matches_reference(golden_gen, tmp_path):
    """Per-cell max-pool intensity accumulation
    (src/elevation_mapping.cpp:154-166) — exact."""
    xyz, T_bs, poses = make_stream(K=4)
    rng = np.random.default_rng(2)
    intensity = rng.uniform(0.0, 100.0, xyz.shape[:2]).astype(np.float32)
    sref = run_reference(golden_gen, tmp_path, xyz, T_bs, poses,
                         "kalman", 0, "local", intensity=intensity)
    _, state = run_ours(xyz, T_bs, poses, "kalman", 0, "local",
                       intensity=intensity)
    a = np.asarray(sref.layers["intensity"])
    b = np.asarray(state.layers["intensity"])
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    both = np.isfinite(a) & np.isfinite(b)
    np.testing.assert_array_equal(a[both], b[both])


def test_npz_interop_through_reference_reader(golden_gen, tmp_path):
    """A map WRITTEN by fastdem_tpu must load through the reference's npz
    reader (src/io_npz.cpp:440-614) and survive its write-back bit-for-bit
    — the schema-compatibility claim, checked against the real parser."""
    from fastdem_tpu.io.npz import save_npz

    xyz, T_bs, poses = make_stream(K=3)
    geom, state = run_ours(xyz, T_bs, poses, "kalman", 0, "local")
    ours = tmp_path / "ours.npz"
    assert save_npz(str(ours), geom, state, frame_id="map")

    out = tmp_path / "roundtrip.npz"
    r = subprocess.run(
        [golden_gen, str(ours), "/dev/null", str(out), "npzload",
         "0", "local", "15", "15", "0.1"],
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    g2, s2, meta = load_npz(str(out))
    assert (g2.rows, g2.cols) == (geom.rows, geom.cols)
    assert abs(g2.resolution - geom.resolution) < 1e-9
    np.testing.assert_allclose(
        np.asarray(s2.position), np.asarray(state.position), atol=1e-9
    )
    assert set(s2.layers) == set(state.layers)
    for name in state.layers:
        np.testing.assert_array_equal(
            np.asarray(s2.layers[name]), np.asarray(state.layers[name]),
            err_msg=name,
        )


@pytest.mark.parametrize("cmap", ["viridis", "jet", "grayscale"])
def test_png_render_matches_reference(golden_gen, tmp_path, cmap):
    """PNG export is PIXEL-IDENTICAL to the reference renderer for every
    colormap: same percentile-1/99 normalization, LUT interpolation,
    rounding, and rgb=0-under-alpha=0 NaN convention."""
    PIL = pytest.importorskip("PIL.Image")
    from fastdem_tpu.io.npz import save_npz
    from fastdem_tpu.io.png import Colormap, PngExportConfig, save_png

    xyz, T_bs, poses = make_stream(K=3)
    geom, state = run_ours(xyz, T_bs, poses, "kalman", 0, "local")
    save_npz(str(tmp_path / "m.npz"), geom, state)
    r = subprocess.run(
        [golden_gen, str(tmp_path / "m.npz"), "/dev/null",
         str(tmp_path / "ref.png"), "png", "0", cmap, "0", "0", "0"],
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    cfg = PngExportConfig()
    cfg.colormap = Colormap(cmap)
    assert save_png(str(tmp_path / "ours.png"), state, "elevation", cfg)
    a = np.asarray(PIL.open(tmp_path / "ref.png").convert("RGBA"))
    b = np.asarray(PIL.open(tmp_path / "ours.png").convert("RGBA"))
    np.testing.assert_array_equal(a, b)


def test_voxelgrid_matches_nanopcl(golden_gen, tmp_path):
    """voxelGrid parity on the raycast hot path's downsampling (the
    reference voxel-downsamples scans before the DDA): CENTROID voxel
    sets and centroids must match nanoPCL's; ANY representatives must
    come from the same voxel set."""
    from fastdem_tpu.cloud.filters import VoxelMode, voxel_coords, voxel_grid
    from fastdem_tpu.cloud.pointcloud import compact, from_numpy
    from fastdem_tpu.io.pcd import load_pcd

    rng = np.random.default_rng(12)
    n = 10000
    xyz = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    res = "0.25"
    with open(tmp_path / "scans.bin", "wb") as f:
        f.write(struct.pack("<ii", 1, n))
        f.write(np.ascontiguousarray(xyz).tobytes())
    with open(tmp_path / "poses.bin", "wb") as f:
        f.write(np.eye(4, dtype=np.float32).tobytes())
        f.write(np.eye(4, dtype=np.float32).tobytes())
    out = tmp_path / "vox"
    r = subprocess.run(
        [golden_gen, str(tmp_path / "scans.bin"), str(tmp_path / "poses.bin"),
         str(out), "voxel", "0", "local", "15", "15", res],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr

    def voxel_key(pts):
        c = np.asarray(voxel_coords(jnp.asarray(pts), float(res)))
        return {tuple(v) for v in c}

    for mode, suffix in ((VoxelMode.CENTROID, ".centroid.pcd"),
                         (VoxelMode.ANY, ".any.pcd")):
        ref = load_pcd(str(out) + suffix)
        ref_pts = np.asarray(ref.xyz)[np.asarray(ref.mask)]
        ours = compact(voxel_grid(from_numpy(xyz), float(res), mode))
        our_pts = np.asarray(ours.xyz)[np.asarray(ours.mask)]
        assert len(ref_pts) == len(our_pts), (mode, len(ref_pts), len(our_pts))
        assert voxel_key(ref_pts) == voxel_key(our_pts), mode
        if mode == VoxelMode.CENTROID:
            # Same centroids voxel-by-voxel (sort both by voxel coord).
            def sort_by_voxel(p):
                c = np.asarray(voxel_coords(jnp.asarray(p), float(res)))
                order = np.lexsort((c[:, 2], c[:, 1], c[:, 0]))
                return p[order]
            np.testing.assert_allclose(
                sort_by_voxel(ref_pts), sort_by_voxel(our_pts), atol=1e-5
            )


def test_registration_matches_nanopcl(golden_gen, tmp_path):
    """Our matmul-based ICP/GICP/VGICP recovers the same rigid transform as
    nanoPCL's implementations on the same cloud pair (both must undo the
    applied motion; VGICP uses the containing-voxel correspondence at the
    same 0.4 m voxel resolution on both sides)."""
    from fastdem_tpu.cloud.pointcloud import from_numpy
    from fastdem_tpu.cloud.registration import align

    rng = np.random.default_rng(6)
    n = 3000
    # Structured target (two planes + a ridge) so ICP is well-conditioned.
    x = rng.uniform(-3, 3, n).astype(np.float32)
    y = rng.uniform(-3, 3, n).astype(np.float32)
    z = (0.3 * np.abs(x) + 0.15 * np.sin(2.0 * y)).astype(np.float32)
    tgt = np.stack([x, y, z], -1).astype(np.float32)
    # True motion: small yaw + translation.
    th = 0.05
    R = np.array(
        [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
         [0, 0, 1]], np.float32,
    )
    t = np.array([0.2, -0.1, 0.05], np.float32)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, :3] = R
    T_true[:3, 3] = t
    # source = inverse-transformed target points (so align(src->tgt) = T_true)
    src = (tgt - t) @ R  # R^T applied: (R^T (p - t))

    data = np.stack([src, tgt]).astype(np.float32)
    with open(tmp_path / "scans.bin", "wb") as f:
        f.write(struct.pack("<ii", 2, n))
        f.write(np.ascontiguousarray(data).tobytes())
    with open(tmp_path / "poses.bin", "wb") as f:
        f.write(np.eye(4, dtype=np.float32).tobytes())
        f.write(np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)).tobytes())
    r = subprocess.run(
        [golden_gen, str(tmp_path / "scans.bin"), str(tmp_path / "poses.bin"),
         "/dev/null", "icp", "0", "local", "15", "15", "0.4"],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    ref_T = {}
    for line in r.stdout.splitlines():
        parts = line.split("T=")
        if len(parts) == 2:
            name = parts[0].split()[0]
            vals = np.array([float(v) for v in parts[1].split()])
            ref_T[name] = vals.reshape(4, 4)
    assert set(ref_T) == {"icp", "gicp", "vgicp"}, r.stdout

    for method in ("icp", "gicp", "vgicp"):
        ours = align(
            from_numpy(src), from_numpy(tgt), method=method,
            max_iterations=50, max_correspondence_distance=1.0,
            voxel_size=0.4,
        )
        T_ours = np.asarray(ours.T)
        # Voxelized correspondences quantize the basin: looser bound.
        tol_t, tol_r = (0.05, 1.0) if method == "vgicp" else (0.01, 0.2)
        for label, T in (("nanopcl", ref_T[method]), ("ours", T_ours)):
            terr = np.linalg.norm(T[:3, 3] - T_true[:3, 3])
            rerr = np.degrees(
                np.arccos(
                    np.clip((np.trace(T[:3, :3] @ R.T) - 1) / 2, -1, 1)
                )
            )
            assert terr < tol_t, f"{method}/{label}: translation err {terr}"
            assert rerr < tol_r, f"{method}/{label}: rotation err {rerr} deg"
        # Ours agrees with nanoPCL's VGICP tighter than with truth.
        if method == "vgicp":
            dd = np.linalg.norm(T_ours[:3, 3] - ref_T[method][:3, 3])
            assert dd < 0.03, f"vgicp ours-vs-nanopcl translation gap {dd}"


def test_pcd_interop_through_nanopcl(golden_gen, tmp_path):
    """A .pcd written by fastdem_tpu parses through nanoPCL's reader and
    survives its binary writer — round-tripped arrays match exactly."""
    from fastdem_tpu.cloud.pointcloud import from_numpy
    from fastdem_tpu.io.pcd import load_pcd, save_pcd

    rng = np.random.default_rng(4)
    n = 5000
    xyz = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    inten = rng.uniform(0, 255, n).astype(np.float32)
    ours = tmp_path / "ours.pcd"
    assert save_pcd(str(ours), from_numpy(xyz, intensity=inten))

    out = tmp_path / "roundtrip.pcd"
    r = subprocess.run(
        [golden_gen, str(ours), "/dev/null", str(out), "pcdload",
         "0", "local", "15", "15", "0.1"],
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    back = load_pcd(str(out))
    assert back.count() == n
    np.testing.assert_array_equal(
        np.asarray(back.xyz)[np.asarray(back.mask)], xyz
    )
    assert back.has("intensity")
    np.testing.assert_array_equal(
        np.asarray(back.channels["intensity"])[np.asarray(back.mask)], inten
    )


def test_color_channel_deviation_is_bounded(golden_gen, tmp_path):
    """The color layer is a DOCUMENTED deviation (PARITY.md): the reference
    keeps the LAST-written point's color per cell, we keep the MIN-Z
    point's. Pin the bound: the packed u8 colors must agree on every
    single-point cell, and every disagreement must still be a color of
    SOME point that hit that cell this run."""
    from fastdem_tpu.utils.colors import pack_rgb

    rng = np.random.default_rng(9)
    K, N = 2, 6000
    xyz, T_bs, poses = make_stream(seed=9, K=K, N=N)
    color = rng.integers(0, 256, (K, N, 3)).astype(np.float32)

    sref = run_reference(golden_gen, tmp_path, xyz, T_bs, poses,
                         "kalman", 0, "global", color=color)

    cfg = Config()
    cfg.mapping.mode = MappingMode.GLOBAL
    geom = GridGeometry.from_length(15.0, 15.0, 0.1)
    step = build_integrate(geom, cfg, has_color=True, donate=False)
    state = create_map_state(geom, cfg, has_color=True)
    for k in range(K):
        packed = pack_rgb(jnp.asarray(color[k]))
        state, _ = step(
            state, jnp.asarray(xyz[k]), jnp.ones(N, bool),
            jnp.asarray(T_bs), jnp.asarray(poses[k]), None, packed,
        )

    a = np.asarray(sref.layers["color"])
    b = np.asarray(state.layers["color"])
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))

    # Per-cell raw point counts + observed color sets from the inputs
    # (n_points counts per-FRAME estimator updates, not raw points).
    counts = np.zeros(geom.num_cells, np.int64)
    cell_colors = {}
    for k in range(K):
        w_xy = xyz[k][:, :2] + poses[k][:2, 3][None]
        ids, inside = geom.cell_id_of(
            jnp.asarray(np.asarray(state.position)), jnp.asarray(w_xy)
        )
        ids = np.asarray(ids)
        inside = np.asarray(inside)
        counts += np.bincount(ids[inside], minlength=geom.num_cells)
        packed = np.asarray(pack_rgb(jnp.asarray(color[k]))).view(np.uint32)
        for i in np.flatnonzero(inside):
            cell_colors.setdefault(int(ids[i]), set()).add(int(packed[i]))

    single = np.isfinite(a) & (
        counts.reshape(geom.rows, geom.cols) == 1
    )
    np.testing.assert_array_equal(a[single], b[single])

    # Multi-point cells: our color must be a color observed in that cell.
    bits_a = a.view(np.uint32)
    bits_b = b.view(np.uint32)
    diff = np.isfinite(a) & (bits_a != bits_b)
    rows, cols = np.nonzero(diff)
    assert diff.sum() < 0.2 * np.isfinite(a).sum()
    for r, c in zip(rows, cols):
        cid = r * geom.cols + c
        assert int(bits_b[r, c]) in cell_colors.get(cid, set()), (r, c)


def test_ghost_clearing_matches_reference(golden_gen, tmp_path):
    """Multi-frame accumulate-then-clear semantics: a floating slab seen in
    one scan and occluded afterwards (rays pass beneath it) must be cleared
    as a ghost by both implementations — same cells."""
    rng = np.random.default_rng(3)
    K, N = 16, 8000
    frames = []
    for k in range(K):
        ang = rng.uniform(0, 2 * np.pi, N).astype(np.float32)
        rad = rng.uniform(0.5, 6.0, N).astype(np.float32)
        x = rad * np.cos(ang)
        y = rad * np.sin(ang)
        z = (0.05 * np.sin(x) - 1.0 + rng.normal(0, 0.01, N)).astype(
            np.float32
        )
        xyz = np.stack([x, y, z], -1)
        # No direct returns near the blob site after scan 0 (occlusion).
        far = np.hypot(x - 2.0, y) > 0.7
        xyz = np.where(
            far[:, None], xyz, np.stack([x * 0 + 5.5, y * 0 + 5.5, z], -1)
        )
        if k == 0:
            bx = rng.uniform(1.9, 2.1, 300)
            by = rng.uniform(-0.1, 0.1, 300)
            bz = rng.uniform(0.4, 0.5, 300)
            xyz[:300] = np.stack([bx, by, bz], -1)
        frames.append(xyz.astype(np.float32))
    xyz = np.stack(frames)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))

    sref = run_reference(golden_gen, tmp_path, xyz, T_bs, poses,
                         "kalman", 1, "global")
    _, state = run_ours(xyz, T_bs, poses, "kalman", 1, "global")
    gr = np.asarray(sref.layers["ghost_removal"])
    gt = np.asarray(state.layers["ghost_removal"])
    ref_clears = np.isfinite(gr) & (gr == 1.0)
    our_clears = np.isfinite(gt) & (gt == 1.0)
    assert ref_clears.sum() > 0, "scenario produced no reference clears"
    np.testing.assert_array_equal(ref_clears, our_clears)
    # The blob must be gone from both elevation maps.
    er = np.asarray(sref.layers["elevation"])
    et = np.asarray(state.layers["elevation"])
    blob = (slice(53, 58), slice(73, 78))
    assert not (np.nan_to_num(er[blob], nan=-9) > 0).any()
    assert not (np.nan_to_num(et[blob], nan=-9) > 0).any()


def test_batch_dem_matches_reference(golden_gen, tmp_path):
    """Offline buildDEM (SOR -> z-histogram floating-point removal ->
    rasterize -> inpaint) vs mapping.batch.build_dem on the same cloud."""
    from fastdem_tpu.cloud.pointcloud import from_numpy
    from fastdem_tpu.mapping.batch import DEMConfig, build_dem

    rng = np.random.default_rng(11)
    n = 20000
    x = rng.uniform(-4, 4, n).astype(np.float32)
    y = rng.uniform(-4, 4, n).astype(np.float32)
    z = (0.2 * np.sin(x) * np.cos(y) + rng.normal(0, 0.02, n)).astype(
        np.float32
    )
    # A few floating outliers the histogram filter must drop.
    z[:40] += 5.0
    xyz = np.stack([x, y, z], -1).astype(np.float32)

    sref = run_reference(
        golden_gen, tmp_path, xyz[None], np.eye(4, dtype=np.float32),
        np.eye(4, dtype=np.float32)[None], "batch", 0, "local",
    )
    geom, state = build_dem(from_numpy(xyz), DEMConfig())

    a = np.asarray(sref.layers["elevation"])
    b = np.asarray(state.layers["elevation"])
    assert a.shape == b.shape, (a.shape, b.shape)
    nan_mis = int((np.isnan(a) != np.isnan(b)).sum())
    # SOR kNN sets may differ at threshold boundaries (approximate kNN on
    # our side, PARITY.md); require near-identical support + tight values.
    assert nan_mis <= a.size * 0.01, f"{nan_mis} nan mismatches"
    both = np.isfinite(a) & np.isfinite(b)
    assert both.sum() > 0.5 * a.size
    md = float(np.abs(a[both] - b[both]).max())
    assert md < 0.05, f"elevation maxdiff {md}"
    p99 = float(np.percentile(np.abs(a[both] - b[both]), 99))
    assert p99 < 1e-4, f"elevation p99 {p99}"


def test_postprocess_chain_matches_reference(golden_gen, tmp_path):
    xyz, T_bs, poses = make_stream()
    sref = run_reference(golden_gen, tmp_path, xyz, T_bs, poses,
                         "kalman", 0, "global", pp=1)
    geom, state = run_ours(xyz, T_bs, poses, "kalman", 0, "global")
    from fastdem_tpu.postprocess import apply_postprocess_fn

    ppc = PostProcessConfig()
    ppc.uncertainty_fusion.enabled = True
    ppc.inpainting.enabled = True
    ppc.inpainting.max_iterations = 3
    ppc.inpainting.min_valid_neighbors = 3
    ppc.feature_extraction.enabled = True
    ppc.feature_extraction.analysis_radius = 0.3
    ppc.feature_extraction.min_valid_neighbors = 4
    fn = apply_postprocess_fn(geom, ppc)
    out = fn(
        state.layers["elevation"],
        state.layers["upper_bound"],
        state.layers["lower_bound"],
    )
    name_map = {"_normal_x": "normal_x", "_normal_y": "normal_y",
                "_normal_z": "normal_z"}
    tol = {"slope": 5e-3}  # degrees; acos near |n_z|=1 is ill-conditioned
    for name in ("elevation", "upper_bound", "lower_bound", "step", "slope",
                 "roughness", "curvature", "_normal_x", "_normal_y",
                 "_normal_z"):
        a = np.asarray(sref.layers[name])
        b = np.asarray(out[name_map.get(name, name)])
        assert_layer(a, b, name, tol.get(name, 2e-6))

    # Median spatial smoothing (the one postprocess op outside the chain;
    # the generator applies it to an elevation copy).
    from fastdem_tpu.postprocess.smoothing import smooth_median

    sm_ref = np.asarray(sref.layers["elevation_smoothed"])
    sm_ours = np.asarray(
        smooth_median(out["elevation"], kernel_size=3, min_valid_neighbors=5)
    )
    assert_layer(sm_ref, sm_ours, "elevation_smoothed", 2e-6)


# ---------------------------------------------------------------------------
# PointCloud2 wire codec goldens (runtime/wire.py vs the reference bridge)
# ---------------------------------------------------------------------------

def _pc2_dump(msg) -> bytes:
    """Serialize wire.PointCloud2 into golden_gen's PC2G container."""
    out = bytearray(b"PC2G")
    out += struct.pack("<I", len(msg.fields))
    for f in msg.fields:
        nb = f.name.encode()
        out += struct.pack("<I", len(nb)) + nb
        out += struct.pack("<III", f.offset, f.datatype, f.count)
    out += struct.pack(
        "<IIII", msg.height, msg.width, msg.point_step, msg.row_step
    )
    out += struct.pack(
        "<BB", 1 if msg.is_bigendian else 0, 1 if msg.is_dense else 0
    )
    out += struct.pack("<Q", len(msg.data)) + msg.data
    fb = msg.frame_id.encode()
    out += struct.pack("<I", len(fb)) + fb
    return bytes(out)


def _pc2_load(raw: bytes):
    from fastdem_tpu.runtime import wire

    assert raw[:4] == b"PC2G"
    off = 4

    def r(fmt):
        nonlocal off
        vals = struct.unpack_from(fmt, raw, off)
        off += struct.calcsize(fmt)
        return vals

    (nf,) = r("<I")
    fields = []
    for _ in range(nf):
        (ln,) = r("<I")
        name = raw[off : off + ln].decode()
        off += ln
        foff, dt, cnt = r("<III")
        fields.append(wire.PointField(name, foff, dt, cnt))
    h, w, ps, rs = r("<IIII")
    be, dense = r("<BB")
    (dl,) = r("<Q")
    data = raw[off : off + dl]
    off += dl
    (fl,) = r("<I")
    frame = raw[off : off + fl].decode()
    return wire.PointCloud2(
        frame_id=frame, stamp_ns=0, height=h, width=w, fields=fields,
        is_bigendian=be != 0, point_step=ps, row_step=rs, data=data,
        is_dense=dense != 0,
    )


def test_pointcloud2_map_bytes_match_reference(golden_gen, tmp_path):
    """map -> PointCloud2: our encoder's field table and data buffer must
    be BYTE-IDENTICAL to the reference's toPointCloud2Impl
    (bridge/ros/impl.hpp:28-174) run on the same map (GLOBAL mode: start
    index 0, so buffer order == world order on both sides)."""
    from fastdem_tpu.io.npz import load_npz as _load
    from fastdem_tpu.io.npz import save_npz
    from fastdem_tpu.runtime import wire

    xyz, T_bs, poses = make_stream(K=3)
    geom, state = run_ours(xyz, T_bs, poses, "kalman", 1, "global")
    npz = tmp_path / "map.npz"
    assert save_npz(str(npz), geom, state)

    out = tmp_path / "ref_pc2.bin"
    r = subprocess.run(
        [golden_gen, str(npz), str(npz), str(out), "pc2", "0", "global",
         "15", "15", "0.1"],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    ref = _pc2_load(out.read_bytes())

    # Encode from the npz-reloaded state (same layer order the reference
    # loader saw — the zip member order).
    geom2, state2, _ = _load(str(npz))
    ours = wire.map_to_pointcloud2(geom2, state2)

    assert [f.name for f in ours.fields] == [f.name for f in ref.fields]
    assert [f.offset for f in ours.fields] == [f.offset for f in ref.fields]
    assert [f.datatype for f in ours.fields] == [
        f.datatype for f in ref.fields
    ]
    assert ours.point_step == ref.point_step
    assert ours.width == ref.width
    assert ours.data == ref.data  # byte-for-byte


def test_pointcloud2_cloud_roundtrip_through_nanopcl(golden_gen, tmp_path):
    """cloud -> PointCloud2 -> nanopcl::from -> nanopcl::to ->
    PointCloud2 -> cloud: our encoder must be readable by nanoPCL's
    reader, nanoPCL's writer output must be readable by our decoder, and
    every channel must survive (bridge/ros/impl.hpp conventions)."""
    from fastdem_tpu.cloud.pointcloud import from_numpy
    from fastdem_tpu.runtime import wire

    rng = np.random.default_rng(3)
    n = 400
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    cloud = from_numpy(
        xyz,
        frame_id="lidar",
        intensity=rng.uniform(0, 100, n).astype(np.float32),
        ring=rng.integers(0, 16, n).astype(np.int32),
        time=rng.uniform(0, 0.1, n).astype(np.float32),
        color=rng.integers(0, 256, (n, 3)).astype(np.uint8),
    )
    ours = wire.cloud_to_pointcloud2(cloud)
    inp = tmp_path / "cloud_pc2.bin"
    inp.write_bytes(_pc2_dump(ours))
    out = tmp_path / "cloud_pc2_back.bin"
    r = subprocess.run(
        [golden_gen, str(inp), str(inp), str(out), "pc2cloud", "0",
         "global", "15", "15", "0.1"],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    back_msg = _pc2_load(out.read_bytes())
    # nanoPCL's writer produces the same field table as ours.
    assert [f.name for f in back_msg.fields] == [
        f.name for f in ours.fields
    ]
    assert [f.offset for f in back_msg.fields] == [
        f.offset for f in ours.fields
    ]
    assert back_msg.point_step == ours.point_step
    assert back_msg.data == ours.data  # lossless both directions

    back = wire.pointcloud2_to_cloud(back_msg)
    np.testing.assert_allclose(
        np.asarray(back.xyz)[np.asarray(back.mask)], xyz, atol=0
    )
    np.testing.assert_array_equal(
        np.asarray(back.channels["ring"]), np.asarray(cloud.channels["ring"])
    )
    np.testing.assert_array_equal(
        np.asarray(back.channels["color"]),
        np.asarray(cloud.channels["color"]),
    )


def test_pcd_metadata_parity_through_nanopcl(golden_gen, tmp_path):
    """VIEWPOINT + normal channels round-trip bit-exactly
    through nanoPCL's reader/writer (PCDMetadata / PCDSaveOptions,
    io/pcd_io.hpp): our writer's viewpoint is parsed and preserved by the
    reference, and its re-written file decodes identically here."""
    from fastdem_tpu.cloud.pointcloud import from_numpy
    from fastdem_tpu.io.pcd import load_pcd, save_pcd

    rng = np.random.default_rng(8)
    n = 2000
    xyz = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    color = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    vp = (1.25, -0.5, 2.0, 0.96891242, 0.0, 0.24740396, 0.0)
    ours = tmp_path / "meta.pcd"
    assert save_pcd(
        str(ours),
        from_numpy(xyz, normal=nrm, color=color),
        viewpoint=vp,
    )

    out = tmp_path / "meta_back.pcd"
    r = subprocess.run(
        [golden_gen, str(ours), "/dev/null", str(out), "pcdload",
         "0", "local", "15", "15", "0.1"],
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    # nanoPCL parsed our viewpoint (printed by the generator).
    assert "viewpoint 1.25 -0.5 2" in r.stdout, r.stdout

    back, meta = load_pcd(str(out), return_meta=True)
    np.testing.assert_allclose(meta["viewpoint"], vp, atol=1e-6)
    keep = np.asarray(back.mask)
    np.testing.assert_array_equal(np.asarray(back.xyz)[keep], xyz)
    np.testing.assert_array_equal(
        np.asarray(back.channels["normal"])[keep][:, :3], nrm
    )
    np.testing.assert_array_equal(
        np.asarray(back.channels["color"])[keep], color
    )


def _logodds_envelope(sref, state, max_frac=0.05, ray_p99=0.15):
    """Shared assertions for raycast parity scenes: ghost decisions EXACT,
    log-odds deviating on < max_frac of touched cells, ray-height p99
    bounded (acceptance: <5% + exact ghosts on adversarial scenes)."""
    a = np.asarray(sref.layers["ghost_removal"])
    b = np.asarray(state.layers["ghost_removal"])
    np.testing.assert_array_equal(
        np.isnan(a), np.isnan(b), err_msg="ghost decisions differ"
    )
    lo_a = np.asarray(sref.layers["_visibility_logodds"])
    lo_b = np.asarray(state.layers["_visibility_logodds"])
    both = np.isfinite(lo_a) & np.isfinite(lo_b)
    frac = float((np.abs(lo_a[both] - lo_b[both]) > 1e-5).mean())
    assert frac < max_frac, f"log-odds deviate on {frac:.3f} of cells"
    ra = np.asarray(sref.layers["raycasting"])
    rb = np.asarray(state.layers["raycasting"])
    rboth = np.isfinite(ra) & np.isfinite(rb)
    p99 = float(np.percentile(np.abs(ra[rboth] - rb[rboth]), 99))
    assert p99 < ray_p99, f"ray-height p99 {p99}"
    return frac, p99


def _adversarial_scene(kind, rng):
    """Scan streams stressing the polar raycast where DDA quantization
    hurts most: thin floating obstacles cleared by
    under-passing rays, grazing incidence from a low sensor, and a sensor
    near the map edge."""
    K, N = 6, 8000
    if kind == "thin_obstacle":
        # Frame 0 paints a floating plate at z=-0.1 over x in [2, 3]; the
        # remaining frames see only ground at rad 3.0-4.3 whose rays (from
        # the z=+1 sensor) pass BELOW the plate through its airspace ->
        # repeated -L_ghost must clear it (0.4 observed - 0.2/frame needs
        # ~8 conflict frames to cross clear_threshold -1.0).
        K = 12
        xyz = np.zeros((K, N, 3), np.float32)
        ang = rng.uniform(-0.18, 0.18, (K, N))
        rad = rng.uniform(3.0, 4.3, (K, N))
        xyz[..., 0] = rad * np.cos(ang)
        xyz[..., 1] = rad * np.sin(ang)
        xyz[..., 2] = -1.0 + rng.normal(0, 0.01, (K, N))
        plate = slice(0, N // 3)
        xyz[0, plate, 0] = rng.uniform(2.0, 3.0, N // 3)
        xyz[0, plate, 1] = rng.uniform(-0.4, 0.4, N // 3)
        xyz[0, plate, 2] = -0.1 + rng.normal(0, 0.005, N // 3)
        T_bs = np.eye(4, dtype=np.float32)
        T_bs[2, 3] = 1.0
        poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        return xyz.astype(np.float32), T_bs, poses, "local"
    if kind == "grazing":
        # Low sensor (0.3 m): shallow downward rays across the whole map.
        ang = rng.uniform(0, 2 * np.pi, (K, N))
        rad = rng.uniform(1.0, 7.0, (K, N))
        x = rad * np.cos(ang)
        y = rad * np.sin(ang)
        z = -0.3 + rng.normal(0, 0.01, (K, N))
        xyz = np.stack([x, y, z], -1).astype(np.float32)
        T_bs = np.eye(4, dtype=np.float32)
        T_bs[2, 3] = 0.3
        poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        return xyz, T_bs, poses, "local"
    # sensor near the map edge (GLOBAL, robot at the corner region)
    ang = rng.uniform(np.pi * 0.9, np.pi * 1.6, (K, N))  # into the map
    rad = rng.uniform(0.5, 7.0, (K, N))
    x = rad * np.cos(ang)
    y = rad * np.sin(ang)
    z = -1.0 + 0.1 * np.sin(2 * x) + rng.normal(0, 0.01, (K, N))
    xyz = np.stack([x, y, z], -1).astype(np.float32)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, 0, 3] = 6.2
    poses[:, 1, 3] = 6.2
    return xyz, T_bs, poses, "global"


@pytest.mark.parametrize(
    "kind", ["thin_obstacle", "grazing", "near_edge"]
)
def test_raycast_adversarial_scenes(golden_gen, tmp_path, kind):
    rng = np.random.default_rng(hash(kind) % 2**31)
    xyz, T_bs, poses, mode = _adversarial_scene(kind, rng)
    sref = run_reference(golden_gen, tmp_path, xyz, T_bs, poses,
                         "kalman", 1, mode)
    _, state = run_ours(xyz, T_bs, poses, "kalman", 1, mode)
    # The thin-obstacle scene must actually exercise ghost clearing.
    if kind == "thin_obstacle":
        assert np.isfinite(
            np.asarray(sref.layers["ghost_removal"])
        ).sum() > 0, "scene failed to trigger reference ghost clearing"
    frac, p99 = _logodds_envelope(sref, state)
    print(f"{kind}: lo-diff frac {frac:.4f}, ray p99 {p99:.3f}")


def test_deskew_matches_nanopcl(golden_gen, tmp_path):
    """Motion compensation: our slerp/lerp per-point deskew vs
    nanopcl::filters::deskew on the same cloud + pose pair + time channel
    (filters/deskew.hpp:97)."""
    from fastdem_tpu.cloud import transform as tfm
    from fastdem_tpu.cloud.filters import deskew
    from fastdem_tpu.cloud.pointcloud import from_numpy

    rng = np.random.default_rng(12)
    n = 4000
    xyz = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    t = np.sort(rng.uniform(0.0, 0.1, n)).astype(np.float32)
    T_start = np.asarray(
        tfm.from_rpy(0.0, 0.0, 0.0, t=[0.0, 0.0, 0.0]), np.float32
    )
    T_end = np.asarray(
        tfm.from_rpy(0.02, -0.01, 0.08, t=[0.5, -0.2, 0.05]), np.float32
    )

    data = np.concatenate([xyz, t[:, None]], axis=1)  # intensity slot=time
    with open(tmp_path / "scans.bin", "wb") as f:
        f.write(struct.pack("<ii", 1, n))
        f.write(np.ascontiguousarray(data, np.float32).tobytes())
    with open(tmp_path / "poses.bin", "wb") as f:
        f.write(np.eye(4, dtype=np.float32).tobytes())
        f.write(T_start.tobytes())
        f.write(T_end.tobytes())
    out = tmp_path / "deskewed.bin"
    r = subprocess.run(
        [golden_gen, str(tmp_path / "scans.bin"), str(tmp_path / "poses.bin"),
         str(out), "deskew", "0", "local", "15", "15", "0.1", "0", "lidar",
         "1", "0"],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    raw = out.read_bytes()
    (n_ref,) = struct.unpack_from("<i", raw, 0)
    ref = np.frombuffer(raw[4:], dtype=np.float32).reshape(n_ref, 3)

    ours = deskew(
        from_numpy(xyz, time=t), jnp.asarray(T_start), jnp.asarray(T_end)
    )
    got = np.asarray(ours.xyz)[np.asarray(ours.mask)]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_segmentation_matches_nanopcl(golden_gen, tmp_path):
    """Euclidean clustering (identical components + membership) and grid
    ground segmentation (identical masks) vs nanoPCL on the same cloud
    (segmentation/euclidean_cluster.hpp, ground_seg.hpp)."""
    from fastdem_tpu.cloud.pointcloud import from_numpy
    from fastdem_tpu.cloud.segmentation import (
        GroundSegConfig,
        euclidean_cluster,
        segment_ground,
    )

    rng = np.random.default_rng(13)
    # Three well-separated blobs above a sparse ground sheet.
    blobs = [
        rng.normal([2.0, 2.0, 1.0], 0.15, (120, 3)),
        rng.normal([-2.5, 1.0, 0.8], 0.15, (90, 3)),
        rng.normal([0.5, -2.0, 1.2], 0.15, (60, 3)),
    ]
    ground = np.column_stack(
        [rng.uniform(-4, 4, 600), rng.uniform(-4, 4, 600),
         rng.normal(0.0, 0.02, 600)]
    )
    xyz = np.vstack(blobs + [ground]).astype(np.float32)
    n = xyz.shape[0]
    tol = 0.5

    with open(tmp_path / "scans.bin", "wb") as f:
        f.write(struct.pack("<ii", 1, n))
        f.write(np.ascontiguousarray(xyz, np.float32).tobytes())
    with open(tmp_path / "poses.bin", "wb") as f:
        f.write(np.eye(4, dtype=np.float32).tobytes())
        f.write(np.eye(4, dtype=np.float32).tobytes())
    out = tmp_path / "seg.bin"
    r = subprocess.run(
        [golden_gen, str(tmp_path / "scans.bin"), str(tmp_path / "poses.bin"),
         str(out), "seg", "0", "local", "15", "15", str(tol)],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    raw = out.read_bytes()
    (n_ref,) = struct.unpack_from("<i", raw, 0)
    assert n_ref == n
    ref_label = np.frombuffer(raw[4 : 4 + 4 * n], dtype=np.int32)
    ref_ground = np.frombuffer(raw[4 + 4 * n :], dtype=np.uint8).astype(bool)

    cloud = from_numpy(xyz)
    ours_label = np.asarray(
        euclidean_cluster(cloud, tolerance=tol, min_cluster_size=5)
    )
    # Same partition: labels must be a bijection between the two labelings
    # on clustered points, with identical noise sets.
    np.testing.assert_array_equal(ours_label < 0, ref_label < 0)
    both = ours_label >= 0
    pairs = set(zip(ours_label[both].tolist(), ref_label[both].tolist()))
    assert len(pairs) == len({a for a, _ in pairs}) == len(
        {b for _, b in pairs}
    ), "cluster memberships differ"

    ours_ground = np.asarray(segment_ground(cloud, GroundSegConfig()))
    np.testing.assert_array_equal(ours_ground, ref_ground)


@pytest.mark.parametrize("fmt", ["tum", "kitti"])
def test_trajectory_io_through_nanopcl(golden_gen, tmp_path, fmt):
    """TUM / KITTI trajectory files written by fastdem_tpu parse through
    nanoPCL's trajectory reader and survive its writer; poses round-trip
    (io/trajectory_io.hpp)."""
    from fastdem_tpu.cloud import transform as tfm
    from fastdem_tpu.io.pcd import (
        load_trajectory,
        save_trajectory_kitti,
        save_trajectory_tum,
    )

    rng = np.random.default_rng(21)
    K = 25
    poses = []
    for k in range(K):
        poses.append(
            np.asarray(
                tfm.from_rpy(
                    *rng.uniform(-0.3, 0.3, 3),
                    t=rng.uniform(-5, 5, 3),
                ),
                np.float64,
            )
        )
    ts = np.sort(rng.uniform(100.0, 200.0, K))

    ours = tmp_path / f"traj.{fmt}"
    if fmt == "tum":
        assert save_trajectory_tum(str(ours), ts, poses)
    else:
        assert save_trajectory_kitti(str(ours), poses)

    out = tmp_path / f"traj_back.{fmt}"
    dummy = tmp_path / "dummy.bin"
    dummy.write_bytes(b"\x00" * 8)
    r = subprocess.run(
        [golden_gen, str(ours), str(dummy), str(out), "traj", "0", fmt,
         "15", "15", "0.1"],
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert f"golden(traj): {K} poses" in r.stdout, r.stdout

    back_ts, back_poses = load_trajectory(str(out))
    assert back_poses.shape == (K, 4, 4)
    for k in range(K):
        np.testing.assert_allclose(
            back_poses[k][:3, 3], poses[k][:3, 3], atol=1e-6
        )
        np.testing.assert_allclose(
            back_poses[k][:3, :3], poses[k][:3, :3], atol=1e-5
        )
    if fmt == "tum":
        np.testing.assert_allclose(np.asarray(back_ts), ts, atol=1e-6)
