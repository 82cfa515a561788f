"""Batched offline replay (build_integrate_sequence / FastDEM.integrate_sequence).

The sequence program must be bitwise equivalent to looping the single-scan
step: same compiled integrate body, scanned over frames. Covers the padding
no-op guarantee (empty frames replicating the last pose), the facade's
bucketing/chunking, provider-driven replay with failure drops, and the
fastdem_replay CLI.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastdem_tpu import Config, GridGeometry
from fastdem_tpu.cloud.pointcloud import from_numpy
from fastdem_tpu.config.config import MappingMode
from fastdem_tpu.grid.gridmap import layers
from fastdem_tpu.mapping.pipeline import (
    FastDEM,
    build_integrate,
    build_integrate_fused,
    build_integrate_sequence,
    create_map_state,
)


def _scans(K, N, rng, step_x=0.3):
    ang = rng.uniform(0, 2 * np.pi, (K, N))
    rad = rng.uniform(0.5, 6.0, (K, N))
    x = rad * np.cos(ang)
    y = rad * np.sin(ang)
    z = 0.2 * np.sin(0.7 * x) * np.cos(0.5 * y) - 1.0 + rng.normal(
        0, 0.02, (K, N)
    )
    xyz = np.stack([x, y, z], -1).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, 0, 3] = step_x * np.arange(K)
    return xyz, poses


@pytest.fixture(scope="module")
def geom():
    return GridGeometry.from_length(12.0, 12.0, 0.1)


def _assert_states_equal(a, b):
    """Exact equality, except the diagnostic min-ray-height layer: XLA may
    contract FMAs differently in the scan body vs the standalone step, and
    a 1-ULP difference in the ray geometry can flip a polar bin at its
    boundary (observed: 1 cell in 14.4K differing by 8 mm < the range-bin
    height). Everything the pipeline DECIDES on (log-odds, ghost clears,
    elevation) must still match exactly."""
    assert set(a.layers) == set(b.layers)
    for name in a.layers:
        av = np.asarray(a.layers[name])
        bv = np.asarray(b.layers[name])
        if name == layers.raycasting:
            nan_mis = int((np.isnan(av) != np.isnan(bv)).sum())
            both = np.isfinite(av) & np.isfinite(bv)
            ndiff = int((av[both] != bv[both]).sum())
            maxd = (
                float(np.abs(av[both] - bv[both]).max()) if both.any() else 0.0
            )
            assert nan_mis + ndiff <= max(1, av.size // 1000), (
                f"raycasting layer: {nan_mis} nan mismatches, {ndiff} diffs"
            )
            assert maxd < 0.06, f"raycasting layer maxdiff {maxd}"
            continue
        np.testing.assert_array_equal(av, bv, err_msg=f"layer {name}")
    np.testing.assert_array_equal(
        np.asarray(a.position), np.asarray(b.position)
    )


@pytest.mark.parametrize("raycast", [False, True])
def test_sequence_matches_step_loop(geom, rng, raycast):
    cfg = Config()
    cfg.raycasting.enabled = raycast
    K, N = 5, 4096
    xyz, poses = _scans(K, N, rng)
    mask = np.ones((K, N), dtype=bool)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0

    step = build_integrate(geom, cfg, donate=False)
    s_loop = create_map_state(geom, cfg)
    for k in range(K):
        s_loop, _ = step(
            s_loop, jnp.asarray(xyz[k]), jnp.asarray(mask[k]),
            jnp.asarray(T_bs), jnp.asarray(poses[k]),
        )

    seq = build_integrate_sequence(geom, cfg, donate=False)
    s_seq = seq(
        create_map_state(geom, cfg),
        jnp.asarray(xyz), jnp.asarray(mask),
        jnp.asarray(T_bs), jnp.asarray(poses),
    )
    _assert_states_equal(s_seq, s_loop)


def test_sequence_per_scan_extrinsic(geom, rng):
    cfg = Config()
    K, N = 3, 2048
    xyz, poses = _scans(K, N, rng)
    mask = np.ones((K, N), dtype=bool)
    tbs = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    tbs[:, 2, 3] = np.linspace(0.5, 1.5, K)

    step = build_integrate(geom, cfg, donate=False)
    s_loop = create_map_state(geom, cfg)
    for k in range(K):
        s_loop, _ = step(
            s_loop, jnp.asarray(xyz[k]), jnp.asarray(mask[k]),
            jnp.asarray(tbs[k]), jnp.asarray(poses[k]),
        )
    seq = build_integrate_sequence(geom, cfg, donate=False)
    s_seq = seq(
        create_map_state(geom, cfg),
        jnp.asarray(xyz), jnp.asarray(mask),
        jnp.asarray(tbs), jnp.asarray(poses),
    )
    _assert_states_equal(s_seq, s_loop)


@pytest.mark.parametrize("raycast", [False, True])
def test_padding_frames_are_noop(geom, rng, raycast):
    """Empty-mask frames replicating the last pose must not change the map,
    including in LOCAL mode (move() to the same position is a no-op) and
    including the per-frame-overwritten layers (obstacle, raycasting —
    regression: a padding frame used to wipe the ray diagnostic layer)."""
    cfg = Config()
    cfg.raycasting.enabled = raycast
    cfg.mapping.mode = MappingMode.LOCAL
    K, N = 3, 2048
    xyz, poses = _scans(K, N, rng)
    mask = np.ones((K, N), dtype=bool)
    T_bs = np.eye(4, dtype=np.float32)

    pad = 3
    xyz_p = np.concatenate([xyz, np.repeat(xyz[-1:], pad, 0)])
    mask_p = np.concatenate([mask, np.zeros((pad, N), dtype=bool)])
    poses_p = np.concatenate([poses, np.repeat(poses[-1:], pad, 0)])

    seq = build_integrate_sequence(geom, cfg, donate=False)
    s_a = seq(
        create_map_state(geom, cfg),
        jnp.asarray(xyz), jnp.asarray(mask),
        jnp.asarray(T_bs), jnp.asarray(poses),
    )
    s_b = seq(
        create_map_state(geom, cfg),
        jnp.asarray(xyz_p), jnp.asarray(mask_p),
        jnp.asarray(T_bs), jnp.asarray(poses_p),
    )
    _assert_states_equal(s_a, s_b)


@pytest.mark.parametrize("raycast", [False, True])
def test_fused_matches_step_loop(geom, rng, raycast):
    """build_integrate_fused batches phase A (scatter/gather) across K
    scans via vmap; the map state must match the sequential loop (same
    per-scan expressions — exact here; the vmapped compilation may in
    principle differ by FMA contraction at discrete bin boundaries, which
    the raycasting-layer tolerance in _assert_states_equal absorbs)."""
    cfg = Config()
    cfg.raycasting.enabled = raycast
    K, N = 5, 4096
    xyz, poses = _scans(K, N, rng)
    mask = np.ones((K, N), dtype=bool)
    mask[2, 1000:] = False  # one sparse frame
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0

    step = build_integrate(geom, cfg, donate=False)
    s_loop = create_map_state(geom, cfg)
    for k in range(K):
        s_loop, _ = step(
            s_loop, jnp.asarray(xyz[k]), jnp.asarray(mask[k]),
            jnp.asarray(T_bs), jnp.asarray(poses[k]),
        )

    fused = build_integrate_fused(geom, cfg, donate=False)
    s_fused = fused(
        create_map_state(geom, cfg),
        jnp.asarray(xyz), jnp.asarray(mask),
        jnp.asarray(T_bs), jnp.asarray(poses),
    )
    _assert_states_equal(s_fused, s_loop)


@pytest.mark.parametrize("raycast", [False, True])
def test_microbatch_matches_step_loop(geom, rng, raycast):
    """microbatch>1 flattens K consecutive scans' irregular ops into single
    offset-index device ops (rasterize_scatter_rows_batched); the map state
    must match the sequential loop on every decision layer (the vmapped
    dense prep may FMA-reassociate at polar-bin boundaries — the
    raycasting-layer tolerance absorbs it). LOCAL mode + a sparse frame +
    intensity cover the position walk, masking, and channel paths."""
    cfg = Config()
    cfg.mapping.mode = MappingMode.LOCAL
    cfg.raycasting.enabled = raycast
    K, N = 8, 4096
    xyz, poses = _scans(K, N, rng, step_x=0.4)
    mask = np.ones((K, N), dtype=bool)
    mask[3, 500:] = False
    intensity = rng.random((K, N)).astype(np.float32)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0

    step = build_integrate(geom, cfg, has_intensity=True, donate=False)
    s_loop = create_map_state(geom, cfg, has_intensity=True)
    for k in range(K):
        s_loop, _ = step(
            s_loop, jnp.asarray(xyz[k]), jnp.asarray(mask[k]),
            jnp.asarray(T_bs), jnp.asarray(poses[k]),
            jnp.asarray(intensity[k]),
        )

    seq = build_integrate_sequence(
        geom, cfg, has_intensity=True, donate=False, microbatch=4
    )
    s_mb = seq(
        create_map_state(geom, cfg, has_intensity=True),
        jnp.asarray(xyz), jnp.asarray(mask),
        jnp.asarray(T_bs), jnp.asarray(poses), jnp.asarray(intensity),
    )
    _assert_states_equal(s_mb, s_loop)


def test_microbatch_requires_divisible_k(geom, rng):
    cfg = Config()
    K, N = 5, 1024
    xyz, poses = _scans(K, N, rng)
    seq = build_integrate_sequence(geom, cfg, donate=False, microbatch=4)
    with pytest.raises(ValueError, match="multiple of microbatch"):
        seq(
            create_map_state(geom, cfg),
            jnp.asarray(xyz), jnp.asarray(np.ones((K, N), bool)),
            jnp.asarray(np.eye(4, dtype=np.float32)), jnp.asarray(poses),
        )


def test_fused_local_mode_follows_robot(geom, rng):
    """LOCAL-mode positions are precomputed as a pose lattice walk inside
    the fused program; the final position and moved layers must match the
    sequential path."""
    cfg = Config()
    cfg.mapping.mode = MappingMode.LOCAL
    K, N = 6, 2048
    xyz, poses = _scans(K, N, rng, step_x=0.75)
    mask = np.ones((K, N), dtype=bool)
    T_bs = np.eye(4, dtype=np.float32)

    step = build_integrate(geom, cfg, donate=False)
    s_loop = create_map_state(geom, cfg)
    for k in range(K):
        s_loop, _ = step(
            s_loop, jnp.asarray(xyz[k]), jnp.asarray(mask[k]),
            jnp.asarray(T_bs), jnp.asarray(poses[k]),
        )
    fused = build_integrate_fused(geom, cfg, donate=False)
    s_fused = fused(
        create_map_state(geom, cfg),
        jnp.asarray(xyz), jnp.asarray(mask),
        jnp.asarray(T_bs), jnp.asarray(poses),
    )
    # Position snaps to the grid lattice; it must track the robot to within
    # half a cell and match the sequential walk exactly.
    assert abs(float(s_fused.position[0]) - 0.75 * (K - 1)) <= 0.05 + 1e-6
    _assert_states_equal(s_fused, s_loop)


def test_facade_sequence_matches_integrate(geom, rng):
    cfg = Config()
    K, N = 7, 3000  # bucketing pads N; batch=3 leaves a short final chunk
    xyz, poses = _scans(K, N, rng)
    T_bs = np.eye(4, dtype=np.float32)

    m1 = FastDEM(geom, Config())
    for k in range(K):
        assert m1.integrate(from_numpy(xyz[k]), T_bs, poses[k])

    m2 = FastDEM(geom, Config())
    n = m2.integrate_sequence(
        [from_numpy(xyz[k]) for k in range(K)], T_bs, poses, batch=3
    )
    assert n == K
    _assert_states_equal(m2.state, m1.state)


def test_facade_sequence_with_channels(geom, rng):
    K, N = 4, 2048
    xyz, poses = _scans(K, N, rng)
    inten = rng.uniform(0, 100, (K, N)).astype(np.float32)
    T_bs = np.eye(4, dtype=np.float32)

    m1 = FastDEM(geom, Config(), has_intensity=True)
    m2 = FastDEM(geom, Config(), has_intensity=True)
    clouds = [
        from_numpy(xyz[k], intensity=inten[k]) for k in range(K)
    ]
    for k in range(K):
        assert m1.integrate(clouds[k], T_bs, poses[k])
    assert m2.integrate_sequence(clouds, T_bs, poses, batch=2) == K
    _assert_states_equal(m2.state, m1.state)
    assert np.isfinite(np.asarray(m2.state.layers[layers.intensity])).any()


def test_facade_sequence_providers_and_drops(geom, rng):
    from fastdem_tpu.runtime.providers import StaticCalibration, TransformBuffer

    K, N = 4, 2048
    xyz, poses = _scans(K, N, rng)
    calib = StaticCalibration("base")
    T_bs = np.eye(4, dtype=np.float32)
    calib.set_extrinsic("lidar", T_bs)
    odom = TransformBuffer("base", "map")
    times = [(k + 1) * 10**9 for k in range(K)]
    for k in range(K - 1):  # no pose for the last scan -> dropped
        odom.add_pose(times[k], poses[k])

    clouds = [
        from_numpy(xyz[k], frame_id="lidar", timestamp_ns=times[k])
        for k in range(K)
    ]
    clouds.append(from_numpy(xyz[0][:0]))  # empty -> dropped
    m = FastDEM(geom, Config())
    m.set_calibration_provider(calib).set_odometry_provider(odom)
    n = m.integrate_sequence(clouds, batch=2)
    assert n == K - 1

    m_ref = FastDEM(geom, Config())
    for k in range(K - 1):
        m_ref.integrate(clouds[k], T_bs, poses[k])
    _assert_states_equal(m.state, m_ref.state)


def test_facade_sequence_no_providers_returns_zero(geom):
    m = FastDEM(geom, Config())
    assert m.integrate_sequence([from_numpy(np.zeros((4, 3)))]) == 0


def test_facade_sequence_pose_only_uses_providers(geom, rng):
    """integrate()'s rule: explicit mode needs BOTH transforms. Passing
    only T_world_base must route through the providers (and use the
    calibrated extrinsic), not silently substitute identity."""
    from fastdem_tpu.runtime.providers import StaticCalibration, TransformBuffer

    K, N = 2, 1024
    xyz, poses = _scans(K, N, rng)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 2.0  # a big extrinsic offset identity would miss
    calib = StaticCalibration("base")
    calib.set_extrinsic("lidar", T_bs)
    odom = TransformBuffer("base", "map")
    times = [(k + 1) * 10**9 for k in range(K)]
    for k in range(K):
        odom.add_pose(times[k], poses[k])
    clouds = [
        from_numpy(xyz[k], frame_id="lidar", timestamp_ns=times[k])
        for k in range(K)
    ]

    m = FastDEM(geom, Config())
    m.set_calibration_provider(calib).set_odometry_provider(odom)
    # Pose-only call: providers resolve T_base_sensor.
    assert m.integrate_sequence(clouds, None, poses, batch=2) == K

    m_ref = FastDEM(geom, Config())
    for k in range(K):
        m_ref.integrate(clouds[k], T_bs, poses[k])
    _assert_states_equal(m.state, m_ref.state)

    # And without providers, pose-only fails like integrate().
    m2 = FastDEM(geom, Config())
    assert m2.integrate_sequence(clouds, None, poses, batch=2) == 0


def test_file_scans_kitti_trajectory(tmp_path):
    """tools.fastdem_node.file_scans auto-detects KITTI (12-col) vs TUM
    (8-col) trajectory files."""
    import os

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from fastdem_node import file_scans

    from fastdem_tpu.io.pcd import save_kitti_bin

    rng = np.random.default_rng(0)
    for i in range(2):
        xyz = rng.uniform(-1, 1, (16, 3)).astype(np.float32)
        save_kitti_bin(
            str(tmp_path / f"{i:06d}.bin"),
            from_numpy(xyz, intensity=np.zeros(16, np.float32)),
        )
    T = np.eye(4)
    lines = []
    for i in range(2):
        T[0, 3] = 1.0 + i
        lines.append(" ".join(f"{v:.6f}" for v in T[:3].reshape(-1)))
    traj = tmp_path / "poses.txt"
    traj.write_text("\n".join(lines) + "\n")

    out = list(file_scans(str(tmp_path), str(traj)))
    assert len(out) == 2
    for i, (xyz, T_wb, _) in enumerate(out):
        assert xyz.shape[1] == 3
        np.testing.assert_allclose(T_wb[0, 3], 1.0 + i, atol=1e-5)


def test_replay_cli(tmp_path):
    out = tmp_path / "replay_out"
    r = subprocess.run(
        [
            sys.executable, "tools/fastdem_replay.py",
            "--config", "fastdem_tpu/config/presets/local_mapping.yaml",
            "--synthetic", "6", "--batch", "4",
            "--out", str(out), "--png", "--platform", "cpu",
        ],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr
    assert (out / "map.npz").exists()
    assert (out / "elevation.png").exists()
    assert "scans/s" in r.stderr


def test_sequence_auto_bucket_bitexact():
    """Batched replay of heavily masked clouds auto-compacts to the ladder
    and still produces the exact per-scan map."""
    import fastdem_tpu as fd
    from fastdem_tpu.cloud import pointcloud as pc

    geom = fd.GridGeometry.from_length(10.0, 10.0, 0.1)
    rng = np.random.default_rng(21)
    clouds = []
    for _ in range(5):
        pts = rng.uniform(-3, 3, (20000, 3)).astype(np.float32)
        pts[:, 2] = 0.2 * np.sin(pts[:, 0]) - 1.0
        pts[rng.random(20000) < 0.7] = np.nan
        clouds.append(pc.from_numpy(pts, frame_id="cam"))
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[:, 0, 3] = 0.05 * np.arange(5)

    m_b = fd.FastDEM(geom, fd.Config())
    m_f = fd.FastDEM(geom, fd.Config())
    m_f.auto_bucket = False
    assert m_b.integrate_sequence(clouds, np.eye(4), poses, batch=3) == 5
    assert m_f.integrate_sequence(clouds, np.eye(4), poses, batch=3) == 5
    # The bucketed program ran at the ladder capacity, not 20000.
    assert any(k[1] == 8192 for k in m_b._seq_cache)
    assert all(k[1] == 20480 for k in m_f._seq_cache)
    # Decision layers are exact; estimator float layers may differ by
    # ~1 ulp of z-variance (XLA contracts the per-point covariance FMAs
    # differently at different capacities).
    for name in ("elevation_min", "elevation_max", "obstacle", "n_points"):
        np.testing.assert_array_equal(
            np.asarray(m_b.state.layers[name]),
            np.asarray(m_f.state.layers[name]),
            err_msg=name,
        )
    for name in m_f.state.layers:
        np.testing.assert_allclose(
            np.asarray(m_b.state.layers[name]),
            np.asarray(m_f.state.layers[name]),
            rtol=1e-5, atol=1e-5, equal_nan=True, err_msg=name,
        )
