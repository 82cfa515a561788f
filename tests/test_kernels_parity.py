"""Parity tests: sort-based kernels vs their scatter oracles.

The production kernels (sorted rasterize, polar raycast) are validated
against the direct scatter formulations on randomized realistic scenes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fastdem_tpu.grid.geometry import GridGeometry
from fastdem_tpu.mapping import rasterize as R
from fastdem_tpu.postprocess import raycasting as RC


def lidar_scene(rng, n=8000):
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(0.3, 8.0, n)
    x = rad * np.cos(ang)
    y = rad * np.sin(ang)
    z = 0.3 * np.sin(x) * np.cos(y) + rng.normal(0, 0.03, n) - 1.0
    xyz = np.column_stack([x, y, z]).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1  # some masked points
    var = np.abs(rng.normal(0.003, 0.001, n)).astype(np.float32)
    inten = rng.uniform(0, 100, n).astype(np.float32)
    return (
        jnp.asarray(xyz),
        jnp.asarray(mask),
        jnp.asarray(var),
        jnp.asarray(inten),
    )


class TestRasterizeParity:
    def test_sorted_equals_scatter(self, rng):
        geom = GridGeometry.from_length(12.0, 12.0, 0.1)
        pos = jnp.zeros(2)
        xyz, mask, var, inten = lidar_scene(rng)
        a = R.rasterize(geom, pos, xyz, mask, var, intensity=inten)
        b = R.rasterize_scatter(geom, pos, xyz, mask, var, intensity=inten)
        np.testing.assert_array_equal(
            np.asarray(a.touched), np.asarray(b.touched)
        )
        for name in ("min_z", "max_z", "min_z_var", "max_intensity"):
            np.testing.assert_allclose(
                np.asarray(getattr(a, name)),
                np.asarray(getattr(b, name)),
                rtol=0,
                atol=0,
                err_msg=name,
            )

    def test_voxel_count_reasonable(self, rng):
        geom = GridGeometry.from_length(4.0, 4.0, 0.5)
        pos = jnp.zeros(2)
        # 3 points in one cell: two in the same z-voxel, one in another.
        xyz = jnp.asarray(
            [[0.1, 0.1, 0.05], [0.12, 0.11, 0.10], [0.13, 0.12, 3.0]],
            dtype=jnp.float32,
        )
        mask = jnp.ones(3, bool)
        var = jnp.zeros(3)
        obs = R.rasterize(geom, pos, xyz, mask, var, with_voxel_count=True)
        r, c, _ = geom.index_of(pos, jnp.asarray([0.1, 0.1]))
        assert float(obs.voxel_count[int(r), int(c)]) == 2.0


class TestRaycastParity:
    def test_polar_close_to_sampled(self, rng):
        """Polar min-ray-height tracks the sampled oracle on touched cells.

        The polar field uses ALL rays while the oracle semantics allow an
        arbitrary representative per voxel, and both discretize
        differently, so comparison is within tolerance on cells both
        touch, and polar must never report a HIGHER min than the oracle by
        more than the discretization error.
        """
        geom = GridGeometry.from_length(12.0, 12.0, 0.1)
        pos = jnp.zeros(2)
        xyz, mask, _, _ = lidar_scene(rng, n=4000)
        origin = jnp.asarray([0.3, -0.2, 0.8])
        h_p, t_p = RC.ray_min_height_polar(geom, pos, xyz, mask, origin)
        h_s, t_s = RC.ray_min_height_sampled(
            geom, pos, xyz, mask, origin, num_samples=1200
        )
        both = np.asarray(t_p) & np.asarray(t_s)
        assert both.sum() > 1000
        hp = np.asarray(h_p)[both]
        hs = np.asarray(h_s)[both]
        # Discretization tolerance: half a range bin * max |slope| plus an
        # azimuth bin of lateral smear; generous bound.
        diff = hp - hs
        assert np.percentile(np.abs(diff), 90) < 0.1
        # Polar uses all rays -> its min should rarely exceed the oracle.
        # The dt-sampled oracle also touches corner-grazed cells that the
        # reference DDA's exit-record semantics barely register; at the
        # r2 azimuth window (AZ_HALF_WIDTH=0.5, tuned to the compiled-
        # reference golden: <5% log-odds envelope, exact ghost decisions)
        # the polar field misses ~3% of the oracle's grazes. The
        # reference golden is the authority; this bound guards gross
        # regressions only.
        assert (diff > 0.15).mean() < 0.04

    def test_exact_window_single_gather_bitwise(self, rng):
        """The exact_window fold (bit-decomposed masked roll-mins over the
        window residual s = w - 2^floor(log2 w)) makes ONE lookup per cell
        cover the same w-bin azimuth window as the two-gather sparse-table
        form: the achievable offsets are subset-sums of s's bits, whose
        p-windows overlap (max gap <= max bit of s < p), so the union is
        contiguous. Min over the identical set => bitwise-equal heights."""
        geom = GridGeometry.from_length(12.0, 12.0, 0.1)
        pos = jnp.zeros(2)
        xyz, mask, _, _ = lidar_scene(rng, n=4000)
        origin = jnp.asarray([0.3, -0.2, 0.8])
        key, vals, size = RC.polar_scatter_spec(geom, pos, xyz, mask, origin)
        table = jnp.full(size, jnp.inf, jnp.float32).at[key].min(vals)[: size - 1]
        h2, t2 = RC.polar_resample(geom, pos, origin, table)
        h1, t1 = RC.polar_resample(
            geom, pos, origin, table, exact_window=True
        )
        np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))
        np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))

    def test_polar_covers_sampled_cells(self, rng):
        geom = GridGeometry.from_length(12.0, 12.0, 0.1)
        pos = jnp.zeros(2)
        xyz, mask, _, _ = lidar_scene(rng, n=4000)
        origin = jnp.asarray([0.0, 0.0, 0.8])
        _, t_p = RC.ray_min_height_polar(geom, pos, xyz, mask, origin)
        _, t_s = RC.ray_min_height_sampled(
            geom, pos, xyz, mask, origin, num_samples=1200
        )
        covered = np.asarray(t_p)[np.asarray(t_s)].mean()
        assert covered > 0.97

    def test_single_ray_heights(self):
        """One straight ray: heights along it must interpolate linearly."""
        geom = GridGeometry.from_length(10.0, 10.0, 0.1)
        pos = jnp.zeros(2)
        # Off the y=0 gridline (cell-boundary rays are knife-edge
        # crossings whose side is arbitrary).
        origin = jnp.asarray([0.0, 0.0, 1.0])
        target = jnp.asarray([[4.0, -0.1, 0.0]], dtype=jnp.float32)
        h, t = RC.ray_min_height_polar(
            geom, pos, target, jnp.ones(1, bool), origin
        )
        r, c, _ = geom.index_of(pos, jnp.asarray([1.95, -0.05]))
        # Height at 2 m along a 4 m ray from z=1 to z=0 is ~0.5, slightly
        # less at the far cell edge.
        val = float(h[int(r), int(c)])
        assert bool(t[int(r), int(c)])
        assert 0.4 < val < 0.55
