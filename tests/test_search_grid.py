"""Exact dense-grid kNN (search.DenseGrid / knn_grid) vs the brute oracle.

The grid path is the sub-quadratic EXACT search:
9 contiguous z-column candidate slices + a per-query exactness
certificate (no column overflow AND kth distance <= bucket side), brute
fallback for failing queries. Reference capability: nanoPCL KdTree /
nanoflann (lib/nanoPCL/include/nanopcl/search/kdtree.hpp:20-49).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fastdem_tpu.cloud import search


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    n = 20000
    xyz = rng.uniform(-15, 15, (n, 3)).astype(np.float32)
    xyz[:, 2] = (
        0.1 * np.sin(xyz[:, 0]) + 0.02 * rng.normal(size=n)
    ).astype(np.float32)
    # Sparse far-away outliers: their kNN radius exceeds any sane bucket
    # side, forcing certificate failures -> the brute fallback runs.
    xyz[:20] *= 6
    mask = np.ones(n, bool)
    mask[7] = False
    return jnp.asarray(xyz), jnp.asarray(mask), xyz, mask


class TestKnnGridExact:
    def test_matches_brute_oracle(self, scene):
        xyzj, maskj, xyz, mask = scene
        gi, gd = search.knn_grid(xyzj, maskj, 10)
        bi, bd = search.knn_brute(xyzj, maskj, 10)
        gi, gd = np.asarray(gi), np.asarray(gd)
        bi, bd = np.asarray(bi), np.asarray(bd)
        # Identical neighbor distances for every VALID query (both paths
        # compute direct-difference distances -> bit-equal, not just
        # close) and identical indices (scene has no exact ties).
        np.testing.assert_array_equal(gd[mask], bd[mask])
        np.testing.assert_array_equal(gi[mask], bi[mask])

    def test_certificate_fallback_triggers(self, scene):
        xyzj, maskj, xyz, mask = scene
        grid = search.DenseGrid(
            xyzj, maskj, search._auto_bucket_size(xyzj, maskj, 10)
        )
        _, _, exact = grid.knn(xyzj, 10, self_pos=grid.inv_order)
        exact = np.asarray(exact)[mask]
        # The outliers must fail the certificate (their kth neighbor is
        # farther than one bucket) while the bulk passes.
        assert not exact.all()
        assert exact.mean() > 0.8

    def test_explicit_queries(self, scene):
        xyzj, maskj, xyz, mask = scene
        q = jnp.asarray(xyz[:64] + 0.01)
        gi, gd = search.knn_grid(xyzj, maskj, 5, queries=q)
        bi, bd = search.knn_brute(
            xyzj, maskj, 5, queries=q, exclude_self=False
        )
        np.testing.assert_array_equal(np.asarray(gd), np.asarray(bd))
        np.testing.assert_array_equal(np.asarray(gi), np.asarray(bi))

    def test_auto_dispatches_exact_above_crossover(self, monkeypatch):
        # Shrink the crossover so the auto path takes the grid branch on a
        # test-sized cloud, and verify exactness end to end.
        monkeypatch.setattr(search, "_GRID_CROSSOVER", 1000)
        rng = np.random.default_rng(11)
        xyz = jnp.asarray(rng.uniform(-5, 5, (4096, 3)).astype(np.float32))
        mask = jnp.ones(4096, bool)
        ai, ad = search.knn(xyz, mask, 8, method="auto")
        bi, bd = search.knn_brute(xyz, mask, 8)
        np.testing.assert_array_equal(np.asarray(ad), np.asarray(bd))
        np.testing.assert_array_equal(np.asarray(ai), np.asarray(bi))

    def test_small_k_and_duplicate_points(self):
        # Duplicate coordinates (zero distances) and k close to n.
        pts = np.array(
            [[0, 0, 0], [0, 0, 0], [1, 0, 0], [0, 1, 0], [5, 5, 5]],
            np.float32,
        )
        pts = np.repeat(pts, 3, axis=0)  # 15 points, triplicated
        xyz = jnp.asarray(pts)
        mask = jnp.ones(15, bool)
        gi, gd = search.knn_grid(xyz, mask, 4, bucket_size=0.5)
        bi, bd = search.knn_brute(xyz, mask, 4)
        np.testing.assert_array_equal(np.asarray(gd), np.asarray(bd))

    def test_radius_grid_matches_brute(self, scene):
        """Exact self radius search at scale via the dense table
        (bucket = radius -> 27-neighborhood covers the ball; overflow-
        only certificate + brute fallback)."""
        xyzj, maskj, xyz, mask = scene
        r, cap = 0.45, 12
        gi, gd, gc = search.radius_search_grid(xyzj, maskj, r, cap)
        bi, bd, bc = search.radius_search_brute(xyzj, maskj, r, cap)
        gi, gd, gc = map(np.asarray, (gi, gd, gc))
        bi, bd, bc = map(np.asarray, (bi, bd, bc))
        # Exact counts everywhere (the set is capped, the count is not).
        np.testing.assert_array_equal(gc[mask], bc[mask])
        np.testing.assert_array_equal(gd[mask], bd[mask])
        np.testing.assert_array_equal(gi[mask], bi[mask])

    def test_radius_grid_overflow_fallback(self):
        # A dense clump overflows its bucket -> fallback rows still exact.
        rng = np.random.default_rng(2)
        pts = np.concatenate([
            rng.normal(0, 0.02, (300, 3)),  # clump: >64 per bucket
            rng.uniform(-4, 4, (2000, 3)),
        ]).astype(np.float32)
        xyz = jnp.asarray(pts)
        mask = jnp.ones(pts.shape[0], bool)
        gi, gd, gc = search.radius_search_grid(xyz, mask, 0.5, 16)
        bi, bd, bc = search.radius_search_brute(xyz, mask, 0.5, 16)
        np.testing.assert_array_equal(np.asarray(gc), np.asarray(bc))
        np.testing.assert_array_equal(np.asarray(gd), np.asarray(bd))

    def test_elongated_grid_chunk_boundary(self):
        """Regression (r5 review): when ncells % cell_chunk != 0, the
        final cell chunk's positive-offset neighbor slices ran past the
        table (dynamic_slice CLAMPS silently) and fetched wrong cells —
        certified exact, so no fallback fired. An elongated cloud makes
        dims like (102, 5, 5) whose ncells is far from chunk-aligned."""
        rng = np.random.default_rng(0)
        n = 20000
        xyz = np.column_stack([
            rng.uniform(0, 100, n), rng.uniform(0, 3, n),
            rng.uniform(0, 3, n),
        ]).astype(np.float32)
        xyzj, maskj = jnp.asarray(xyz), jnp.ones(n, bool)
        gi, gd = search.knn_grid(xyzj, maskj, 10, bucket_size=1.0)
        bi, bd = search.knn_brute(xyzj, maskj, 10)
        np.testing.assert_array_equal(np.asarray(gd), np.asarray(bd))
        np.testing.assert_array_equal(np.asarray(gi), np.asarray(bi))
        ri, rd, rc = search.radius_search_grid(xyzj, maskj, 1.0, 8)
        bi2, bd2, bc2 = search.radius_search_brute(xyzj, maskj, 1.0, 8)
        np.testing.assert_array_equal(np.asarray(rc), np.asarray(bc2))
        np.testing.assert_array_equal(np.asarray(rd), np.asarray(bd2))

    def test_normals_grid_method(self, scene):
        from fastdem_tpu.cloud import normals
        from fastdem_tpu.cloud.pointcloud import from_numpy

        xyzj, maskj, xyz, mask = scene
        c = from_numpy(xyz[:5000])
        out_g = normals.estimate_normals(c, k=10, method="grid")
        out_b = normals.estimate_normals(c, k=10, method="brute")
        ng = np.asarray(out_g.channels["normal"])
        nb = np.asarray(out_b.channels["normal"])
        # Same neighborhoods -> same PCA normals (sign-aligned already).
        np.testing.assert_allclose(ng, nb, atol=1e-5)
