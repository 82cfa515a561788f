"""Shared example utilities: synthetic data, timing, ASCII visualization.

Equivalents of the reference examples' common helpers
(/root/reference/fastdem/examples/common/: data_loader.hpp:32-53 terrain
generator, timer.hpp, viz.hpp ASCII renderer).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def force_platform(platform=None):
    """Pick the JAX platform (before any backend is created)."""
    if platform:
        import jax

        jax.config.update("jax_platforms", platform)


def generate_terrain_cloud(num_points=20000, extent=10.0, seed=42):
    """Sinusoidal terrain + noise (data_loader.hpp:32-53 semantics:
    z = 0.3 sin(0.5 x) cos(0.5 y) + N(0, 0.02))."""
    from fastdem_tpu.cloud import pointcloud as pc

    rng = np.random.default_rng(seed)
    x = rng.uniform(-extent / 2, extent / 2, num_points)
    y = rng.uniform(-extent / 2, extent / 2, num_points)
    z = 0.3 * np.sin(x * 0.5) * np.cos(y * 0.5) + rng.normal(
        0, 0.02, num_points
    )
    return pc.from_numpy(
        np.column_stack([x, y, z]).astype(np.float32), frame_id="lidar"
    )


def generate_ground_with_obstacles(num_points=20000, extent=10.0, seed=42):
    """Flat ground + box obstacles (data_loader.hpp second generator)."""
    from fastdem_tpu.cloud import pointcloud as pc

    rng = np.random.default_rng(seed)
    n_g = int(num_points * 0.8)
    n_o = num_points - n_g
    gx = rng.uniform(-extent / 2, extent / 2, n_g)
    gy = rng.uniform(-extent / 2, extent / 2, n_g)
    gz = rng.normal(0, 0.01, n_g)
    centers = rng.uniform(-extent / 3, extent / 3, size=(4, 2))
    which = rng.integers(0, 4, n_o)
    ox = centers[which, 0] + rng.uniform(-0.3, 0.3, n_o)
    oy = centers[which, 1] + rng.uniform(-0.3, 0.3, n_o)
    oz = rng.uniform(0.0, 1.0, n_o)
    pts = np.column_stack(
        [np.concatenate([gx, ox]), np.concatenate([gy, oy]),
         np.concatenate([gz, oz])]
    ).astype(np.float32)
    return pc.from_numpy(pts, frame_id="lidar")


class Timer:
    """Scoped wall timer (examples/common/timer.hpp)."""

    def __init__(self, label="elapsed"):
        self.label = label

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        print(f"[{self.label}] {(time.time() - self.t0) * 1e3:.2f} ms")


def ascii_render(layer, width=60):
    """Coarse ASCII elevation view (examples/common viz equivalent)."""
    arr = np.asarray(layer)
    h, w = arr.shape
    step_r = max(1, h // (width // 2))
    step_c = max(1, w // width)
    sub = arr[::step_r, ::step_c]
    finite = np.isfinite(sub)
    if not finite.any():
        return "(empty map)"
    lo, hi = np.nanmin(sub), np.nanmax(sub)
    rng = hi - lo if hi > lo else 1.0
    ramp = " .:-=+*#%@"
    rows = []
    for r in sub:
        row = []
        for v in r:
            if not np.isfinite(v):
                row.append(" ")
            else:
                row.append(ramp[int((v - lo) / rng * (len(ramp) - 1))])
        rows.append("".join(row))
    return "\n".join(rows)
