"""Window-local map updates (pipeline `window_update`).

On maps larger than the sensor range, per-scan work — the rasterizer's
scatter tables AND the dense estimator/min-max/obstacle/raycast layer
passes — runs on a sensor-centered window of ~2*range extent
(dynamic-sliced, updated, written back), making per-scan cost O(range^2)
instead of O(map area). Every touched cell lies inside the window (the
range filter bounds points in the BASE frame; the window carries the same
base->sensor margin as the polar-field bound — default 2 m, widened by
the facade when a larger extrinsic registers), so results must be EXACTLY
equal to the full-map path — these tests assert bitwise equality on every
layer, the aux observations, and the position.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fastdem_tpu import Config, GridGeometry
from fastdem_tpu.config.config import EstimationType, MappingMode
from fastdem_tpu.mapping.pipeline import build_integrate, create_map_state


def _run(geom, cfg, window_update, rng_seed=0, K=5, N=4096, step_x=2.0,
         x0=-4.0):
    rng = np.random.default_rng(rng_seed)
    step = build_integrate(
        geom, cfg, has_intensity=True, donate=False,
        window_update=window_update,
    )
    s = create_map_state(geom, cfg, has_intensity=True)
    aux = None
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    for k in range(K):
        ang = rng.uniform(0, 2 * np.pi, N)
        rad = rng.uniform(0.5, 5.8, N)
        px = x0 + step_x * k
        x = rad * np.cos(ang)
        y = rad * np.sin(ang)
        z = (
            0.2 * np.sin(0.6 * (x + px)) * np.cos(0.5 * y)
            - 1.0
            + rng.normal(0, 0.02, N)
        )
        xyz = np.stack([x, y, z], -1).astype(np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = px
        mask = np.ones(N, bool)
        mask[:37] = False
        inten = rng.random(N).astype(np.float32)
        s, aux = step(
            s, jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(T_bs),
            jnp.asarray(pose), jnp.asarray(inten),
        )
    return s, aux


def _assert_exact(s1, a1, s2, a2):
    assert set(s1.layers) == set(s2.layers)
    for k in s1.layers:
        np.testing.assert_array_equal(
            np.asarray(s1.layers[k]), np.asarray(s2.layers[k]),
            err_msg=f"layer {k}",
        )
    np.testing.assert_array_equal(
        np.asarray(s1.position), np.asarray(s2.position)
    )
    for f in ("min_z", "min_z_var", "max_z", "touched", "max_intensity",
              "voxel_count"):
        va, vb = getattr(a1.obs, f), getattr(a2.obs, f)
        if va is None:
            assert vb is None
            continue
        np.testing.assert_array_equal(
            np.asarray(va), np.asarray(vb), err_msg=f"aux obs.{f}"
        )


@pytest.mark.parametrize("raycast", [False, True])
@pytest.mark.parametrize(
    "est", [EstimationType.KALMAN, EstimationType.P2_QUANTILE]
)
def test_global_windowed_exact(raycast, est):
    cfg = Config()
    cfg.mapping.mode = MappingMode.GLOBAL
    cfg.mapping.estimation_type = est
    cfg.raycasting.enabled = raycast
    cfg.point_filter.range_max = 6.0
    geom = GridGeometry.from_length(40.0, 40.0, 0.1)
    s1, a1 = _run(geom, cfg, window_update=False)
    s2, a2 = _run(geom, cfg, window_update=None)  # auto -> windowed
    _assert_exact(s1, a1, s2, a2)


def test_local_big_map_windowed_exact():
    """LOCAL mode: the window is computed from the post-move position and
    the update runs after the roll — must match the full path including
    across moves."""
    cfg = Config()
    cfg.mapping.mode = MappingMode.LOCAL
    cfg.point_filter.range_max = 6.0
    cfg.raycasting.enabled = True
    geom = GridGeometry.from_length(40.0, 40.0, 0.1)
    s1, a1 = _run(geom, cfg, window_update=False, step_x=1.3)
    s2, a2 = _run(geom, cfg, window_update=None, step_x=1.3)
    _assert_exact(s1, a1, s2, a2)


def test_small_map_auto_stays_full():
    """Auto windowing must not engage when the window covers most of the
    map (the headline 15 m LOCAL config keeps its exact program)."""
    from fastdem_tpu.mapping import pipeline as pl

    cfg = Config()
    geom = GridGeometry.from_length(15.0, 15.0, 0.1)
    _, _, _, pab = pl._build_phases(
        geom, cfg, None, None, None, "rows", None
    )
    # rows mode + no window -> the batched harness stays available, which
    # doubles as the "windowed is off" indicator for this config.
    assert pab is not None


def test_small_ray_max_range_does_not_shrink_window():
    """raycasting.max_range bounds the polar ray FIELD only; the update
    window must derive from the point filter — a small max_range must not
    mask far points out of the rasterization (regression: the window was
    briefly sized from ray_max_range)."""
    cfg = Config()
    cfg.mapping.mode = MappingMode.GLOBAL
    cfg.point_filter.range_max = 6.0
    cfg.raycasting.enabled = True
    cfg.raycasting.max_range = 3.0  # << the point range
    geom = GridGeometry.from_length(40.0, 40.0, 0.1)
    s1, a1 = _run(geom, cfg, window_update=False)
    s2, a2 = _run(geom, cfg, window_update=None)
    _assert_exact(s1, a1, s2, a2)


class TestExtrinsicMarginGuard:
    """a base->sensor translation beyond the built window
    margin must never silently drop points — the low-level step reports
    them (aux.oow_points), the facade widens the margin automatically."""

    def _boom_setup(self):
        cfg = Config()
        cfg.mapping.mode = MappingMode.GLOBAL
        cfg.point_filter.range_max = 6.0
        geom = GridGeometry.from_length(40.0, 40.0, 0.1)
        # 3 m boom along +x: points cluster around the SENSOR, the window
        # bound assumes they cluster around the BASE within margin.
        T_bs = np.eye(4, dtype=np.float32)
        T_bs[0, 3] = 3.0
        T_bs[2, 3] = 1.0
        rng = np.random.default_rng(5)
        N = 4096
        ang = rng.uniform(0, 2 * np.pi, N)
        rad = rng.uniform(0.5, 5.8, N)
        # Cloud centered on the BASE (sensor-frame coords shifted by the
        # inverse boom): every point passes the base-frame range filter
        # (<= 5.8 m), but points on the far side sit up to 8.8 m from the
        # SENSOR the window centers on — past a tight window bound.
        xyz = np.stack(
            [rad * np.cos(ang) - T_bs[0, 3], rad * np.sin(ang),
             rng.normal(-2.0, 0.05, N)], -1
        ).astype(np.float32)
        pose = np.eye(4, dtype=np.float32)
        return cfg, geom, T_bs, xyz, pose, N

    def test_oow_points_reported_and_zero_with_wide_margin(self):
        cfg, geom, T_bs, xyz, pose, N = self._boom_setup()
        # Points live within 5.8 m of the SENSOR (3 m off-base): the base
        # range filter (range_max 6) rejects the far lobe, but survivors
        # can still sit past the default window. Build with a deliberately
        # TIGHT margin to force drops, then with a wide one.
        s = create_map_state(geom, cfg)
        step_tight = build_integrate(
            geom, cfg, donate=False, window_margin=0.0
        )
        _, aux = step_tight(
            s, jnp.asarray(xyz), jnp.ones(N, bool), jnp.asarray(T_bs),
            jnp.asarray(pose),
        )
        assert aux.oow_points is not None
        assert int(aux.oow_points) > 0  # the silent-drop case, now visible

        step_wide = build_integrate(
            geom, cfg, donate=False, window_margin=4.0
        )
        _, aux2 = step_wide(
            s, jnp.asarray(xyz), jnp.ones(N, bool), jnp.asarray(T_bs),
            jnp.asarray(pose),
        )
        assert aux2.oow_points is not None
        assert int(aux2.oow_points) == 0

    def test_widened_margin_matches_full_map(self):
        """Windowed with margin covering the boom == full-map path."""
        cfg, geom, T_bs, xyz, pose, N = self._boom_setup()
        outs = []
        for wu, margin in ((False, 2.0), (None, 4.0)):
            s = create_map_state(geom, cfg)
            step = build_integrate(
                geom, cfg, donate=False, window_update=wu,
                window_margin=margin,
            )
            s, _ = step(
                s, jnp.asarray(xyz), jnp.ones(N, bool), jnp.asarray(T_bs),
                jnp.asarray(pose),
            )
            outs.append(s)
        for k in outs[0].layers:
            np.testing.assert_array_equal(
                np.asarray(outs[0].layers[k]), np.asarray(outs[1].layers[k]),
                err_msg=f"layer {k}",
            )

    def test_facade_widens_margin_on_boom_extrinsic(self, caplog):
        import logging

        import fastdem_tpu as fd
        from fastdem_tpu.cloud.pointcloud import from_numpy

        cfg, geom, T_bs, xyz, pose, N = self._boom_setup()
        mapper = fd.FastDEM(geom, cfg)
        assert mapper._window_margin == 2.0
        with caplog.at_level(logging.WARNING, logger="fastdem_tpu"):
            ok = mapper.integrate(
                from_numpy(xyz), T_base_sensor=T_bs, T_world_base=pose
            )
        assert ok
        assert mapper._window_margin > 3.0
        assert any("window margin" in r.message for r in caplog.records)
        # After widening, nothing is dropped.
        assert mapper.last_aux.oow_points is None or (
            int(mapper.last_aux.oow_points) == 0
        )


def test_sensor_near_map_edge_windowed_exact():
    """Window clamping at the map boundary must not change results."""
    cfg = Config()
    cfg.mapping.mode = MappingMode.GLOBAL
    cfg.point_filter.range_max = 6.0
    cfg.raycasting.enabled = True
    geom = GridGeometry.from_length(40.0, 40.0, 0.1)
    s1, a1 = _run(geom, cfg, window_update=False, x0=-18.5, step_x=1.0)
    s2, a2 = _run(geom, cfg, window_update=None, x0=-18.5, step_x=1.0)
    _assert_exact(s1, a1, s2, a2)
