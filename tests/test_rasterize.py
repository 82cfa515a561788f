"""Rasterization tests (mirrors reference tests/test_rasterization.cpp at
behavior level: min/max/mean reductions, per-cell variance, counts; plus
min-z-variance carry and tie semantics)."""

import jax.numpy as jnp
import numpy as np
import pytest

from fastdem_tpu.grid.geometry import GridGeometry
from fastdem_tpu.mapping import rasterize as R


GEOM = GridGeometry.from_length(2.0, 2.0, 1.0)  # 2x2 cells centered at 0
POS = jnp.zeros(2)


def raster(xyz, var=None, mask=None, **kw):
    xyz = jnp.asarray(xyz, dtype=jnp.float32)
    n = xyz.shape[0]
    if var is None:
        var = jnp.full(n, 0.01, dtype=jnp.float32)
    if mask is None:
        mask = jnp.ones(n, dtype=bool)
    return R.rasterize(GEOM, POS, xyz, mask, jnp.asarray(var), **kw)


class TestRasterize:
    def test_min_max_per_cell(self):
        # Cell (0,0) covers x in (0, 1], y in (0, 1].
        obs = raster([[0.5, 0.5, 1.0], [0.5, 0.5, 3.0], [0.6, 0.4, 2.0]])
        assert float(obs.min_z[0, 0]) == 1.0
        assert float(obs.max_z[0, 0]) == 3.0
        assert bool(obs.touched[0, 0])
        assert not bool(obs.touched[1, 1])
        assert np.isnan(float(obs.min_z[1, 1]))

    def test_min_var_carried_from_min_point(self):
        obs = raster(
            [[0.5, 0.5, 2.0], [0.5, 0.5, 1.0]], var=[0.111, 0.222]
        )
        assert float(obs.min_z_var[0, 0]) == pytest.approx(0.222)

    def test_tie_takes_smaller_variance(self):
        obs = raster([[0.5, 0.5, 1.0], [0.5, 0.5, 1.0]], var=[0.3, 0.1])
        assert float(obs.min_z_var[0, 0]) == pytest.approx(0.1)

    def test_masked_points_ignored(self):
        obs = raster(
            [[0.5, 0.5, 1.0], [0.5, 0.5, -5.0]],
            mask=jnp.array([True, False]),
        )
        assert float(obs.min_z[0, 0]) == 1.0

    def test_out_of_map_ignored(self):
        obs = raster([[10.0, 10.0, 1.0]])
        assert not bool(jnp.any(obs.touched))

    def test_intensity_max_pool(self):
        obs = raster(
            [[0.5, 0.5, 1.0], [0.5, 0.5, 2.0]],
            intensity=jnp.array([3.0, 7.0]),
        )
        assert float(obs.max_intensity[0, 0]) == 7.0

    def test_quadrants(self):
        # row/col axes: +x -> row 0, -x -> row 1; +y -> col 0, -y -> col 1.
        obs = raster(
            [
                [0.5, 0.5, 1.0],
                [-0.5, 0.5, 2.0],
                [0.5, -0.5, 3.0],
                [-0.5, -0.5, 4.0],
            ]
        )
        assert float(obs.min_z[0, 0]) == 1.0
        assert float(obs.min_z[1, 0]) == 2.0
        assert float(obs.min_z[0, 1]) == 3.0
        assert float(obs.min_z[1, 1]) == 4.0


class TestRasterizeStats:
    def test_count_mean_var(self, rng):
        zs = rng.normal(2.0, 0.5, size=40).astype(np.float32)
        xyz = np.column_stack(
            [np.full(40, 0.5), np.full(40, 0.5), zs]
        ).astype(np.float32)
        stats = R.rasterize_stats(
            GEOM, POS, jnp.asarray(xyz), jnp.ones(40, bool)
        )
        assert float(stats.count[0, 0]) == 40
        assert float(stats.mean[0, 0]) == pytest.approx(zs.mean(), rel=1e-4)
        assert float(stats.variance[0, 0]) == pytest.approx(
            np.var(zs, ddof=1), rel=1e-3
        )
        assert float(stats.min_z[0, 0]) == pytest.approx(zs.min())
        assert float(stats.max_z[0, 0]) == pytest.approx(zs.max())

    def test_single_point_zero_variance(self):
        stats = R.rasterize_stats(
            GEOM, POS, jnp.asarray([[0.5, 0.5, 1.0]]), jnp.ones(1, bool)
        )
        assert float(stats.variance[0, 0]) == 0.0


def raster_packed(xyz, var=None, mask=None, **kw):
    xyz = jnp.asarray(xyz, dtype=jnp.float32)
    n = xyz.shape[0]
    if var is None:
        var = jnp.full(n, 0.01, dtype=jnp.float32)
    if mask is None:
        mask = jnp.ones(n, dtype=bool)
    return R.rasterize_scatter_packed(
        GEOM, POS, xyz, mask, jnp.asarray(var), **kw
    )


class TestRasterizePacked:
    """Single-scatter argmin-carry formulation (rasterize_scatter_packed):
    semantics tests + randomized parity against the sorted oracle."""

    def test_min_max_var_carry(self):
        obs = raster_packed(
            [[0.5, 0.5, 2.0], [0.5, 0.5, 1.0], [0.6, 0.4, 5.0]],
            var=[0.111, 0.222, 0.5],
        )
        assert float(obs.min_z[0, 0]) == 1.0
        assert float(obs.max_z[0, 0]) == 5.0
        assert float(obs.min_z_var[0, 0]) == pytest.approx(0.222)

    def test_tie_takes_first_point(self):
        # Exact z ties resolve to the smallest point INDEX (the reference's
        # first-strict-min order, elevation_mapping.cpp:65-71).
        obs = raster_packed(
            [[0.5, 0.5, 1.0], [0.5, 0.5, 1.0]], var=[0.3, 0.1]
        )
        assert float(obs.min_z_var[0, 0]) == pytest.approx(0.3)

    def test_all_masked(self):
        obs = raster_packed(
            [[0.5, 0.5, 1.0]], mask=jnp.zeros(1, dtype=bool)
        )
        assert not bool(jnp.any(obs.touched))

    def test_single_point_min_equals_max(self):
        obs = raster_packed([[0.5, 0.5, 1.25]])
        assert float(obs.min_z[0, 0]) == 1.25
        assert float(obs.max_z[0, 0]) == 1.25

    def test_randomized_parity_vs_sorted(self, rng):
        geom = GridGeometry.from_length(8.0, 8.0, 0.25)
        n = 5000
        xyz = np.zeros((n, 3), dtype=np.float32)
        xyz[:, :2] = rng.uniform(-4.5, 4.5, size=(n, 2))
        xyz[:, 2] = rng.uniform(-1.0, 2.0, size=n)
        mask = rng.random(n) > 0.15
        var = rng.uniform(1e-3, 0.1, size=n).astype(np.float32)
        inten = rng.uniform(0, 50, size=n).astype(np.float32)
        col = rng.uniform(0, 1, size=n).astype(np.float32)
        kw = dict(
            intensity=jnp.asarray(inten),
            color_packed=jnp.asarray(col),
            with_voxel_count=True,
        )
        a = R.rasterize(
            geom, POS, jnp.asarray(xyz), jnp.asarray(mask),
            jnp.asarray(var), **kw
        )
        b = R.rasterize_scatter_packed(
            geom, POS, jnp.asarray(xyz), jnp.asarray(mask),
            jnp.asarray(var), **kw
        )
        quantum = 3.0 / ((1 << (31 - 13)) - 1)  # z-range / levels (n=5000)
        np.testing.assert_array_equal(
            np.asarray(a.touched), np.asarray(b.touched)
        )
        for name in ("min_z", "max_z", "min_z_var", "max_intensity",
                     "color", "voxel_count"):
            x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
            assert (np.isnan(x) == np.isnan(y)).all(), name
            fin = np.isfinite(x)
            tol = quantum if name == "min_z" else 0.0
            if name == "min_z_var":
                # var@min may come from a different sub-quantum-tie point;
                # bound not meaningful — just require it to be one of the
                # cell's variances (checked via the sorted oracle's bound).
                continue
            assert np.abs(x[fin] - y[fin]).max() <= tol, name

    def test_ordered_involution_roundtrip(self):
        vals = jnp.asarray(
            [0.0, -0.0, 1.5, -1.5, 1e-38, -1e-38, 3e38, -3e38, jnp.inf,
             -jnp.inf],
            dtype=jnp.float32,
        )
        enc = R._f32_ordered_i32(vals)
        dec = R._i32_ordered_f32(enc)
        np.testing.assert_array_equal(np.asarray(vals), np.asarray(dec))
        # Order preserved (excluding +-0.0: the int encoding strictly
        # orders -0.0 < +0.0 while float comparison treats them equal).
        nz = vals[jnp.asarray(vals) != 0.0]
        enc_nz = R._f32_ordered_i32(nz)
        np.testing.assert_array_equal(
            np.asarray(jnp.argsort(nz)), np.asarray(jnp.argsort(enc_nz))
        )

    def test_large_map_per_point_path(self, rng):
        # ncell > 2n triggers the per-point argmin realization (the
        # cell-indexed gather would scale with MAP AREA); results must
        # match the sorted oracle exactly on tie-free input.
        geom = GridGeometry.from_length(30.0, 30.0, 0.1)
        n = 2000
        assert geom.num_cells > 2 * n
        xyz = np.zeros((n, 3), dtype=np.float32)
        xyz[:, :2] = rng.uniform(-14, 14, size=(n, 2))
        xyz[:, 2] = rng.uniform(-1, 2, size=n)
        mask = jnp.asarray(rng.random(n) > 0.1)
        var = jnp.asarray(rng.uniform(1e-3, 0.05, n).astype(np.float32))
        a = R.rasterize(
            geom, POS, jnp.asarray(xyz), mask, var, with_voxel_count=True
        )
        b = R.rasterize_scatter_packed(
            geom, POS, jnp.asarray(xyz), mask, var, with_voxel_count=True
        )
        for name in ("min_z", "min_z_var", "max_z", "voxel_count"):
            x = np.asarray(getattr(a, name))
            y = np.asarray(getattr(b, name))
            assert (np.isnan(x) == np.isnan(y)).all(), name
            fin = np.isfinite(x)
            np.testing.assert_array_equal(x[fin], y[fin], err_msg=name)

    def test_voxel_count_span_vs_exact(self):
        # Two z clusters with a gap: exact counts occupied voxels (2),
        # span counts the full extent (z-gap included).
        xyz = [[0.5, 0.5, 0.05], [0.5, 0.5, 10.05]]
        a = raster_packed(xyz, with_voxel_count=True,
                          voxel_count_mode="exact")
        b = raster_packed(xyz, with_voxel_count=True,
                          voxel_count_mode="span")
        assert float(a.voxel_count[0, 0]) == 2.0
        assert float(b.voxel_count[0, 0]) == 11.0  # floor(10.05)-floor(.05)+1
        # Contiguous cluster: identical.
        xyz2 = [[0.5, 0.5, 0.1], [0.5, 0.5, 0.4], [0.5, 0.5, 1.2]]
        a2 = raster_packed(xyz2, with_voxel_count=True,
                           voxel_count_mode="exact")
        b2 = raster_packed(xyz2, with_voxel_count=True,
                           voxel_count_mode="span")
        assert float(a2.voxel_count[0, 0]) == float(b2.voxel_count[0, 0]) == 2.0


def raster_rows(xyz, var=None, mask=None, geom=None, **kw):
    xyz = jnp.asarray(xyz, dtype=jnp.float32)
    n = xyz.shape[0]
    if var is None:
        var = jnp.full(n, 0.01, dtype=jnp.float32)
    if mask is None:
        mask = jnp.ones(n, dtype=bool)
    return R.rasterize_scatter_rows(
        geom or GEOM, POS, xyz, mask, jnp.asarray(var), **kw
    )


class TestRasterizeRows:
    """Row-widened single-index scatter (rasterize_scatter_rows, round 2):
    min_z is EXACT (its own ordered lane), var/color argmin-carried."""

    def test_min_max_var_carry(self):
        obs = raster_rows(
            [[0.5, 0.5, 2.0], [0.5, 0.5, 1.0], [0.6, 0.4, 5.0]],
            var=[0.111, 0.222, 0.5],
        )
        assert float(obs.min_z[0, 0]) == 1.0
        assert float(obs.max_z[0, 0]) == 5.0
        assert float(obs.min_z_var[0, 0]) == pytest.approx(0.222)

    def test_tie_takes_first_point(self):
        obs = raster_rows(
            [[0.5, 0.5, 1.0], [0.5, 0.5, 1.0]], var=[0.3, 0.1]
        )
        assert float(obs.min_z_var[0, 0]) == pytest.approx(0.3)

    def test_all_masked(self):
        obs = raster_rows([[0.5, 0.5, 1.0]], mask=jnp.zeros(1, dtype=bool))
        assert not bool(jnp.any(obs.touched))

    def test_randomized_parity_vs_sorted(self, rng):
        geom = GridGeometry.from_length(8.0, 8.0, 0.25)
        n = 5000
        xyz = np.zeros((n, 3), dtype=np.float32)
        xyz[:, :2] = rng.uniform(-4.5, 4.5, size=(n, 2))
        xyz[:, 2] = rng.uniform(-1.0, 2.0, size=n)
        mask = rng.random(n) > 0.15
        var = rng.uniform(1e-3, 0.1, size=n).astype(np.float32)
        inten = rng.uniform(0, 50, size=n).astype(np.float32)
        col = rng.uniform(0, 1, size=n).astype(np.float32)
        kw = dict(
            intensity=jnp.asarray(inten),
            color_packed=jnp.asarray(col),
            with_voxel_count=True,
        )
        a = R.rasterize(
            geom, POS, jnp.asarray(xyz), jnp.asarray(mask),
            jnp.asarray(var), **kw
        )
        b = R.rasterize_scatter_rows(
            geom, POS, jnp.asarray(xyz), jnp.asarray(mask),
            jnp.asarray(var), **kw
        )
        np.testing.assert_array_equal(
            np.asarray(a.touched), np.asarray(b.touched)
        )
        # min_z is now exact (ordered lane) — zero tolerance everywhere.
        for name in ("min_z", "max_z", "max_intensity", "voxel_count"):
            x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
            assert (np.isnan(x) == np.isnan(y)).all(), name
            fin = np.isfinite(x)
            np.testing.assert_array_equal(x[fin], y[fin], err_msg=name)

    def test_large_map_per_point_path(self, rng):
        geom = GridGeometry.from_length(30.0, 30.0, 0.1)
        n = 2000
        assert geom.num_cells > 2 * n
        xyz = np.zeros((n, 3), dtype=np.float32)
        xyz[:, :2] = rng.uniform(-14, 14, size=(n, 2))
        xyz[:, 2] = rng.uniform(-1, 2, size=n)
        mask = jnp.asarray(rng.random(n) > 0.1)
        var = jnp.asarray(rng.uniform(1e-3, 0.05, n).astype(np.float32))
        a = R.rasterize(
            geom, POS, jnp.asarray(xyz), mask, var, with_voxel_count=True
        )
        b = R.rasterize_scatter_rows(
            geom, POS, jnp.asarray(xyz), mask, var, with_voxel_count=True
        )
        for name in ("min_z", "min_z_var", "max_z", "voxel_count"):
            x = np.asarray(getattr(a, name))
            y = np.asarray(getattr(b, name))
            assert (np.isnan(x) == np.isnan(y)).all(), name
            fin = np.isfinite(x)
            np.testing.assert_array_equal(x[fin], y[fin], err_msg=name)

    def test_voxel_count_exact_bitmap(self):
        xyz = [[0.5, 0.5, 0.05], [0.5, 0.5, 10.05]]
        a = raster_rows(xyz, with_voxel_count=True, voxel_count_mode="exact")
        b = raster_rows(xyz, with_voxel_count=True, voxel_count_mode="span")
        assert float(a.voxel_count[0, 0]) == 2.0
        assert float(b.voxel_count[0, 0]) == 11.0

    def test_matches_packed_path(self, rng):
        n = 3000
        xyz = np.zeros((n, 3), dtype=np.float32)
        xyz[:, :2] = rng.uniform(-2.2, 2.2, size=(n, 2))
        xyz[:, 2] = rng.uniform(-1.0, 2.0, size=n)
        var = rng.uniform(1e-3, 0.1, size=n).astype(np.float32)
        a = raster_rows(xyz, var=var, with_voxel_count=True)
        b = raster_packed(xyz, var=var, with_voxel_count=True)
        for name in ("max_z", "voxel_count", "min_z_var"):
            x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
            assert (np.isnan(x) == np.isnan(y)).all(), name
            fin = np.isfinite(x)
            np.testing.assert_array_equal(x[fin], y[fin], err_msg=name)


@pytest.mark.parametrize(
    "fn", [R.rasterize_scatter_rows, R.rasterize_scatter_packed],
    ids=["rows", "packed"],
)
def test_quant_mask_resolves_ties_like_the_whole_scan(fn):
    """A sharded map's device rasterizes only its block's points; with
    ``quant_mask`` = every point its sub-quantum z ties resolve as in the
    whole-scan rasterization (the argmin carries the same variance),
    bitwise. Without it, its narrower z range splits the ties."""
    geom = GridGeometry.from_length(10.0, 10.0, 0.1)  # 100 x 100
    pos = jnp.zeros(2)
    rng = np.random.default_rng(5)
    pts, var = [], []
    # 600 points: 2^21 quantization levels. Over the whole scan's 1000 m z
    # range a quantum is ~5e-4 m, so A's pairs 1e-5 m apart tie (the
    # smaller index, the higher point, wins); over A's own ~1 m range
    # they do not (the lower point wins).
    for c in range(200):  # block A: rows < 50 (x > 0), z in [0, 1]
        r, col = 5 + c // 40, 5 + c % 40
        x = 5.0 - (r + 0.5) * 0.1
        y = 5.0 - (col + 0.5) * 0.1
        base = rng.uniform(0.0, 1.0)
        pts += [(x, y, base + 1e-5), (x, y, base)]  # higher z first
        var += [0.01, 0.02]
    for c in range(200):  # block B: rows >= 50, z spans [-500, 500]
        r, col = 60 + c // 40, 5 + c % 40
        pts.append((5.0 - (r + 0.5) * 0.1, 5.0 - (col + 0.5) * 0.1,
                    rng.uniform(-500.0, 500.0)))
        var.append(0.03)
    xyz = jnp.asarray(np.asarray(pts, np.float32))
    z_var = jnp.asarray(np.asarray(var, np.float32))
    every = jnp.ones(xyz.shape[0], bool)
    block_a = jnp.asarray(np.asarray(pts)[:, 0] > 0.0)

    whole = fn(geom, pos, xyz, every, z_var)
    dev = fn(geom, pos, xyz, block_a, z_var, quant_mask=every)
    narrow = fn(geom, pos, xyz, block_a, z_var)
    half = slice(0, 50)
    np.testing.assert_array_equal(
        np.asarray(dev.min_z_var)[half], np.asarray(whole.min_z_var)[half]
    )
    np.testing.assert_array_equal(
        np.asarray(dev.min_z)[half], np.asarray(whole.min_z)[half]
    )
    assert not np.array_equal(
        np.asarray(narrow.min_z_var)[half],
        np.asarray(whole.min_z_var)[half],
        equal_nan=True,
    )


class TestSentinelCollision:
    def test_power_of_two_max_index_point_not_dropped(self):
        """Regression: with n a power of two, a valid point at index n-1
        holding the scan's max z used to pack lane 0 to exactly the _IMAX
        invalid sentinel, silently marking its (otherwise untouched) cell
        as untouched. qmax now leaves one quantization level of headroom."""
        import jax.numpy as jnp

        from fastdem_tpu.grid.geometry import GridGeometry
        from fastdem_tpu.mapping.rasterize import (
            rasterize_scatter_packed,
            rasterize_scatter_rows,
        )

        geom = GridGeometry.from_length(4.0, 4.0, 0.1)
        n = 4096  # power of two -> idx_bits covers all-ones at n-1
        xyz = np.zeros((n, 3), dtype=np.float32)
        xyz[:, 0] = -1.0  # everyone else shares one far cell
        xyz[:, 2] = 0.5
        xyz[n - 1] = (1.0, 1.0, 2.0)  # index n-1: alone, scan max z
        mask = np.ones(n, bool)
        zv = np.full(n, 0.01, np.float32)
        pos = jnp.zeros(2)
        for fn in (rasterize_scatter_rows, rasterize_scatter_packed):
            obs = fn(geom, pos, jnp.asarray(xyz), jnp.asarray(mask),
                     jnp.asarray(zv))
            r, c, inside = geom.index_of(pos, jnp.asarray([[1.0, 1.0]]))
            assert bool(inside[0])
            assert bool(obs.touched[int(r[0]), int(c[0])]), fn.__name__
            assert float(obs.min_z[int(r[0]), int(c[0])]) == 2.0, fn.__name__
