#!/usr/bin/env python
"""Large fixed-origin GLOBAL map with window-local per-scan updates.

The reference's global mode (200x200 m @ 0.1 m, ros2/config/
global_mapping.yaml) processes the whole 4M-cell map every scan. Here a
range filter bounds where a scan can land, so the pipeline automatically
dynamic-slices a sensor-centered window (~2x the range bound), runs the
identical per-cell update there, and writes it back — per-scan cost is
O(range^2), independent of map area (PERF.md has the H100 numbers).
Results are exactly equal to the full-map path
(tests/test_window_update.py).

A robot drives a long loop across a 120x120 m world; the final DEM and a
submap around the end pose are exported.

Run: python examples/09_global_windowed_mapping.py [--platform cpu]
"""
import sys

import numpy as np

from common import Timer, ascii_render, force_platform

force_platform("cpu" if "--platform" in sys.argv and "cpu" in sys.argv else None)

import fastdem_tpu as fd
from fastdem_tpu.cloud.pointcloud import from_numpy
from fastdem_tpu.config.config import MappingMode


def world_height(x, y):
    return (
        0.4 * np.sin(0.12 * x) * np.cos(0.1 * y)
        + 0.15 * np.sin(0.45 * x + 1.0)
    )


def scan_at(px, py, n=24000, rng=None):
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(0.5, 11.5, n)
    wx = px + rad * np.cos(ang)
    wy = py + rad * np.sin(ang)
    wz = world_height(wx, wy) + rng.normal(0, 0.02, n)
    # sensor frame: base at (px, py, 0), sensor 1 m above
    pts = np.column_stack([wx - px, wy - py, wz - 1.0]).astype(np.float32)
    return from_numpy(pts)


def main():
    geom = fd.GridGeometry.from_length(120.0, 120.0, 0.1)  # 1.44M cells
    cfg = fd.Config()
    cfg.mapping.mode = MappingMode.GLOBAL
    cfg.point_filter.range_max = 12.0  # bounds the update window
    cfg.raycasting.enabled = True
    mapper = fd.FastDEM(geom, cfg)

    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    rng = np.random.default_rng(3)

    K = 40
    t = np.linspace(0, 2 * np.pi, K, endpoint=False)
    path_x = 35.0 * np.cos(t)
    path_y = 25.0 * np.sin(2 * t) * 0.8

    with Timer(f"integrate {K} scans along a {2 * np.pi * 35:.0f} m loop"):
        for px, py in zip(path_x, path_y):
            pose = np.eye(4, dtype=np.float32)
            pose[0, 3] = px
            pose[1, 3] = py
            assert mapper.integrate(scan_at(px, py, rng=rng), T_bs, pose)

    elev = np.asarray(mapper.state.layers["elevation"])
    measured = int(np.isfinite(elev).sum())
    print(
        f"measured {measured} of {geom.num_cells} cells "
        f"({100.0 * measured / geom.num_cells:.1f}% — the driven corridor)"
    )

    # Accuracy along the corridor vs the ground truth.
    cx, cy = geom.cell_centers(mapper.state.position)
    truth = world_height(np.asarray(cx), np.asarray(cy))
    err = np.abs(elev - truth)[np.isfinite(elev)]
    print(f"height error: p50 {np.percentile(err, 50) * 100:.1f} cm, "
          f"p95 {np.percentile(err, 95) * 100:.1f} cm")

    # A 15x15 m submap around the end pose (the reference publishes this
    # window for visualization, ros2/src/fastdem_ros_node.cpp:271-280).
    from fastdem_tpu.grid.gridmap import submap_slices

    rs, cs = submap_slices(
        geom, mapper.state.position, (path_x[-1], path_y[-1]), (15.0, 15.0)
    )
    print("submap around the end pose:")
    print(ascii_render(elev[rs, cs]))


if __name__ == "__main__":
    main()
