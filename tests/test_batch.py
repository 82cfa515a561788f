"""Batch DEM pipeline + search + normal-estimation tests (mirrors reference
tests/test_rasterization.cpp buildDEM cases and nanoPCL search/geometry
suites at behavior level)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from fastdem_tpu.cloud import filters as pcf
from fastdem_tpu.cloud import normals as nrm
from fastdem_tpu.cloud import pointcloud as pc
from fastdem_tpu.cloud import search
from fastdem_tpu.config.config import RasterMethod
from fastdem_tpu.grid.gridmap import layers
from fastdem_tpu.mapping import batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ground_with_canopy(rng, n_ground=2000, n_canopy=200):
    g = np.column_stack(
        [
            rng.uniform(-5, 5, n_ground),
            rng.uniform(-5, 5, n_ground),
            rng.normal(0.0, 0.02, n_ground),
        ]
    )
    c = np.column_stack(
        [
            rng.uniform(-5, 5, n_canopy),
            rng.uniform(-5, 5, n_canopy),
            rng.normal(5.0, 0.1, n_canopy),
        ]
    )
    return np.vstack([g, c]).astype(np.float32)


class TestSearch:
    def test_knn_brute_exact(self, rng):
        pts = rng.normal(size=(200, 3)).astype(np.float32)
        cloud = pc.from_numpy(pts)
        idx, dist = search.knn_brute(cloud.xyz, cloud.mask, 3)
        # Cross-check one query against numpy.
        q = 7
        d = np.linalg.norm(pts - pts[q], axis=1)
        d[q] = np.inf
        expect = np.sort(d)[:3]
        np.testing.assert_allclose(np.sort(np.asarray(dist[q])), expect, rtol=1e-4)

    def test_knn_excludes_self(self, rng):
        pts = rng.normal(size=(50, 3)).astype(np.float32)
        cloud = pc.from_numpy(pts)
        idx, _ = search.knn_brute(cloud.xyz, cloud.mask, 2)
        for i in range(50):
            assert i not in np.asarray(idx[i])

    def test_bucket_grid_radius_count(self):
        pts = np.array(
            [[0, 0, 0], [0.05, 0, 0], [0.0, 0.05, 0], [2, 2, 2]],
            dtype=np.float32,
        )
        cloud = pc.from_numpy(pts)
        grid = search.BucketGrid(cloud.xyz, cloud.mask, 0.1)
        cnt = grid.radius_count(
            cloud.xyz, 0.1,
            exclude_self_idx=jnp.arange(4, dtype=jnp.int32),
        )
        assert int(cnt[0]) == 2
        assert int(cnt[3]) == 0

    def test_bucket_knn_close_to_brute(self, rng):
        pts = rng.uniform(-1, 1, size=(500, 3)).astype(np.float32)
        cloud = pc.from_numpy(pts)
        _, d_brute = search.knn_brute(cloud.xyz, cloud.mask, 4)
        grid = search.BucketGrid(cloud.xyz, cloud.mask, 0.4)
        _, d_bucket = grid.knn(
            cloud.xyz, 4, per_bucket=16,
            exclude_self_idx=jnp.arange(500, dtype=jnp.int32),
        )
        # Bucketed kNN is approximate; most distances should match.
        close = np.isclose(
            np.asarray(d_brute), np.asarray(d_bucket), rtol=1e-3
        ).mean()
        assert close > 0.9


class TestOutlierRemoval:
    def test_sor_removes_isolated_point(self, rng):
        pts = rng.normal(scale=0.2, size=(300, 3)).astype(np.float32)
        pts = np.vstack([pts, [[50.0, 50.0, 50.0]]]).astype(np.float32)
        cloud = pc.from_numpy(pts)
        out = pcf.statistical_outlier_removal(cloud, k=10, std_mul=1.0)
        assert not bool(out.mask[300])
        assert out.count() > 250

    def test_radius_outlier_removal(self):
        pts = np.array(
            [[0, 0, 0], [0.05, 0, 0], [0.07, 0.01, 0], [9, 9, 9]],
            dtype=np.float32,
        )
        cloud = pc.from_numpy(pts)
        out = pcf.radius_outlier_removal(cloud, radius=0.2, min_neighbors=1)
        assert out.count() == 3
        assert not bool(out.mask[3])


class TestNormals:
    def test_flat_plane_normals_up(self, rng):
        xy = rng.uniform(-1, 1, size=(300, 2))
        pts = np.column_stack([xy, np.zeros(300)]).astype(np.float32)
        cloud = pc.from_numpy(pts)
        out = nrm.estimate_normals(cloud, k=8, viewpoint=(0, 0, 10.0))
        n = np.asarray(out.channels["normal"])
        nz = np.abs(n[:, 2])
        assert np.mean(nz > 0.99) > 0.95
        # Oriented toward the viewpoint above the plane.
        assert np.mean(n[:, 2] > 0) > 0.95

    def test_covariances_regularized(self, rng):
        xy = rng.uniform(-1, 1, size=(200, 2))
        pts = np.column_stack([xy, 0.01 * xy[:, 0]]).astype(np.float32)
        cloud = pc.from_numpy(pts)
        out = nrm.estimate_covariances(cloud, k=8)
        cov = np.asarray(out.channels["covariance"])
        eig = np.linalg.eigvalsh(cov)
        # Plane-to-plane regularization: eigenvalues ~ (eps, 1, 1).
        np.testing.assert_allclose(eig[:, 2], 1.0, atol=0.05)
        assert np.all(eig[:, 0] < 0.1)


class TestBatchDEM:
    def test_from_pointcloud_methods(self, rng):
        pts = np.array(
            [[0.05, 0.05, 1.0], [0.05, 0.05, 3.0], [0.05, 0.05, 2.0]],
            dtype=np.float32,
        )
        cloud = pc.from_numpy(pts)
        geom, state = batch.from_pointcloud_auto(cloud, 1.0, RasterMethod.MAX)
        elev = np.asarray(state.layers[layers.elevation])
        assert np.nanmax(elev) == pytest.approx(3.0)
        _, state = batch.from_pointcloud_auto(cloud, 1.0, RasterMethod.MIN)
        assert np.nanmin(np.asarray(state.layers[layers.elevation])) == (
            pytest.approx(1.0)
        )
        _, state = batch.from_pointcloud_auto(cloud, 1.0, RasterMethod.MEAN)
        vals = np.asarray(state.layers[layers.elevation])
        assert np.nanmax(vals) == pytest.approx(2.0, rel=1e-5)

    def test_auto_geometry_covers_points(self, rng):
        pts = rng.uniform(-3, 7, size=(500, 3)).astype(np.float32)
        cloud = pc.from_numpy(pts)
        geom, state = batch.from_pointcloud_auto(cloud, 0.5)
        n = np.asarray(state.layers[layers.n_points])
        assert np.nansum(n) == 500  # every point inside the auto bbox

    def test_remove_floating_points(self, rng):
        pts = ground_with_canopy(rng)
        cloud = pc.from_numpy(pts)
        geom, position = batch.bbox_geometry(pts, np.ones(len(pts), bool), 0.5)
        out = batch.remove_floating_points(
            cloud, geom, position, height_threshold=2.0, bin_size=0.5
        )
        kept = np.asarray(out.mask)
        assert kept[:2000].mean() > 0.99  # ground kept
        assert kept[2000:].mean() < 0.05  # canopy removed

    def test_build_dem_pipeline(self, rng):
        pts = ground_with_canopy(rng)
        cloud = pc.from_numpy(pts)
        geom, state = batch.build_dem(
            cloud, batch.DEMConfig(resolution=0.5)
        )
        elev = np.asarray(state.layers[layers.elevation])
        finite = np.isfinite(elev)
        assert finite.mean() > 0.8  # inpainted coverage
        assert abs(np.nanmedian(elev)) < 0.2  # canopy didn't leak into DEM

    def test_round_trip_to_pointcloud(self, rng):
        pts = ground_with_canopy(rng, n_canopy=0)
        cloud = pc.from_numpy(pts)
        geom, state = batch.build_dem(
            cloud, batch.DEMConfig(resolution=0.5, inpaint_iterations=0)
        )
        out = batch.to_pointcloud(geom, state)
        assert out.count() > 100
        z = np.asarray(out.xyz)[:, 2]
        assert np.abs(np.median(z)) < 0.2


class TestCli:
    def test_pcd2dem_cli(self, rng, tmp_path):
        import subprocess
        import sys

        from fastdem_tpu.io import pcd as pcd_io

        pts = ground_with_canopy(rng, n_ground=800, n_canopy=50)
        cloud = pc.from_numpy(pts)
        src = str(tmp_path / "in.pcd")
        dst = str(tmp_path / "out.pcd")
        npz = str(tmp_path / "m.npz")
        pcd_io.save_pcd(src, cloud)
        env = dict(
            __import__("os").environ,
            JAX_PLATFORMS="cpu",
            PYTHONPATH=REPO,
        )
        r = subprocess.run(
            [sys.executable, "tools/pcd2dem.py", src, dst, "0.5", "--npz", npz,
             "--platform", "cpu"],
            capture_output=True, text=True, cwd=REPO, env=env,
            timeout=300,
        )
        assert r.returncode == 0, r.stderr
        back = pcd_io.load_pcd(dst)
        assert back.count() > 50
        from fastdem_tpu.io.npz import load_npz

        geom, state, meta = load_npz(npz)
        assert layers.elevation in state.layers


class TestRegistration:
    """Registration tests (behavior level of nanoPCL registration suite)."""

    def make_pair(self, rng, n=600):
        from fastdem_tpu.cloud import transform as tfm

        # Structured scene: two walls + ground (well-constrained in 6DoF).
        g = np.column_stack(
            [rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), np.zeros(n)]
        )
        w1 = np.column_stack(
            [rng.uniform(-2, 2, n // 2), np.full(n // 2, 2.0),
             rng.uniform(0, 1, n // 2)]
        )
        w2 = np.column_stack(
            [np.full(n // 2, -2.0), rng.uniform(-2, 2, n // 2),
             rng.uniform(0, 1, n // 2)]
        )
        tgt = np.vstack([g, w1, w2]).astype(np.float32)
        T_true = np.asarray(
            tfm.from_rpy(0.02, -0.015, 0.05, t=[0.1, -0.07, 0.04])
        )
        src = (tgt @ np.asarray(T_true)[:3, :3].T + T_true[:3, 3]).astype(
            np.float32
        )
        # src = T_true * tgt  ->  aligning src onto tgt recovers inv(T_true)
        return src, tgt, np.linalg.inv(T_true)

    @pytest.mark.parametrize("method", ["icp", "point_to_plane", "gicp", "vgicp"])
    def test_align_recovers_transform(self, rng, method):
        from fastdem_tpu.cloud import registration as reg

        src, tgt, T_expect = self.make_pair(rng)
        # vgicp: containing-voxel correspondence (reference semantics,
        # r2) needs voxels large enough that the scene's plane spacing
        # doesn't alias — nanoPCL's own alignVGICP diverges on this pair
        # at 0.4 m and converges at 0.8 m; match its working setting.
        res = reg.align(
            pc.from_numpy(src),
            pc.from_numpy(tgt),
            method=method,
            max_iterations=40,
            max_correspondence_distance=1.0,
            voxel_size=0.8 if method == "vgicp" else 0.4,
            # vgicp + plain GN oscillates on some seeds (nanoPCL's does
            # too — its solver damps with lambda=1e-3); the adaptive LM
            # schedule is the robust configuration. GN-vs-nanoPCL parity
            # is pinned by test_registration_matches_nanopcl.
            optimizer="lm" if method == "vgicp" else "gn",
        )
        err_t = np.linalg.norm(res.T[:3, 3] - T_expect[:3, 3])
        err_R = np.linalg.norm(res.T[:3, :3] - T_expect[:3, :3])
        tol_t = 0.08 if method == "vgicp" else 0.03
        assert err_t < tol_t, (method, res.T, T_expect, res.iterations)
        assert err_R < 0.05, (method, err_R)

    @pytest.mark.parametrize("method", ["icp", "gicp", "vgicp"])
    def test_lm_optimizer_recovers_transform(self, rng, method):
        """Adaptive Levenberg-Marquardt (reference lm_optimizer.hpp
        schedule): same recovery as GN on well-posed pairs, and monotone
        accepted error."""
        from fastdem_tpu.cloud import registration as reg

        src, tgt, T_expect = self.make_pair(rng)
        res = reg.align(
            pc.from_numpy(src),
            pc.from_numpy(tgt),
            method=method,
            max_iterations=40,
            optimizer="lm",
            voxel_size=0.8,
        )
        err_t = np.linalg.norm(res.T[:3, 3] - T_expect[:3, 3])
        assert err_t < 0.08, (method, res.T, res.iterations)

    def test_vgicp_containing_voxel_vs_nearest_mean(self, rng):
        """The round-1 implementation corresponded each point to the
        nearest voxel MEAN over all voxels; the reference (and now this
        implementation) uses the voxel CONTAINING the transformed point.
        On a sparse anisotropic scene the two disagree: a point just
        outside an occupied voxel has a nearest mean but NO containing
        voxel. Pin the semantic: such points contribute no
        correspondence."""
        import jax.numpy as jnp

        from fastdem_tpu.cloud import registration as reg
        from fastdem_tpu.cloud.filters import voxel_coords

        # One occupied voxel cluster at the origin, one lone query point
        # 1.5 voxels away: nearest-mean would match it; containment must
        # not.
        tgt = rng.normal(0, 0.05, size=(50, 3)).astype(np.float32)
        tc = pc.from_numpy(tgt)
        keys, vmean, vcov, vvalid = reg.voxel_distributions(tc, 0.4)
        q = np.array([[0.65, 0.0, 0.0]], np.float32)  # voxel (1,0,0): empty
        coords = voxel_coords(jnp.asarray(q), 0.4)
        B = 1024
        key = (
            (jnp.clip(coords[:, 0] + B // 2, 0, B - 1) * B
             + jnp.clip(coords[:, 1] + B // 2, 0, B - 1)) * B
            + jnp.clip(coords[:, 2] + B // 2, 0, B - 1)
        )
        pos = jnp.clip(jnp.searchsorted(keys, key), 0, keys.shape[0] - 1)
        assert not bool((keys[pos] == key)[0]), "empty voxel must not match"
        # ...whereas the nearest MEAN exists (would have matched in r1).
        d = np.linalg.norm(np.asarray(vmean)[np.asarray(vvalid)] - q, axis=1)
        assert d.min() < 0.7

    def test_robust_kernel_with_outliers(self, rng):
        from fastdem_tpu.cloud import registration as reg

        src, tgt, T_expect = self.make_pair(rng)
        n_out = 100
        outliers = rng.uniform(-8, 8, size=(n_out, 3)).astype(np.float32)
        src_o = np.vstack([src, outliers])
        res = reg.align(
            pc.from_numpy(src_o),
            pc.from_numpy(tgt),
            method="icp",
            kernel="huber",
            kernel_scale=0.3,
            max_iterations=40,
        )
        err_t = np.linalg.norm(res.T[:3, 3] - T_expect[:3, 3])
        assert err_t < 0.06


class TestExactSearchAnyN:
    """exact kNN / radius counts above 64K points (the old
    auto path fell back to an approximate bucket search there). Oracle =
    dense numpy distances on sampled queries."""

    def test_knn_exact_at_100k(self, rng):
        n = 100_000
        xyz = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
        mask = jnp.asarray(rng.random(n) > 0.05)
        k = 10
        idx, dist = search.knn(jnp.asarray(xyz), mask, k, method="auto")
        idx = np.asarray(idx)
        dist = np.asarray(dist)
        m = np.asarray(mask)
        qs = rng.integers(0, n, 64)
        for q in qs:
            if not m[q]:
                # Masked self-queries are UNDEFINED (r5 contract: the
                # dense-table grid path returns idx=-1/dist=inf for them
                # — padded sentinel points must not cost brute work; no
                # consumer reads masked rows, filters.py SOR masks them).
                continue
            d2 = np.sum((xyz - xyz[q]) ** 2, axis=1)
            d2[~m] = np.inf
            d2[q] = np.inf
            oracle = np.sort(np.sqrt(d2))[:k]
            # Final distances are exact direct differences (the Gram
            # form only pre-selects candidates) — f32-tight match.
            np.testing.assert_allclose(
                dist[q], oracle, rtol=1e-6, atol=1e-6,
                err_msg=f"query {q}",
            )
            got = np.sort(np.sqrt(np.maximum(d2[idx[q]], 0)))
            np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=1e-6)

    def test_knn_brute_running_topk_matches_single_tile(self, rng):
        # Multi-data-chunk merge == single-tile result on a small cloud.
        n = 3000
        xyz = jnp.asarray(rng.uniform(-5, 5, size=(n, 3)).astype(np.float32))
        mask = jnp.ones(n, dtype=bool)
        i1, d1 = search.knn_brute(xyz, mask, 5, data_chunk=256)
        i2, d2 = search.knn_brute(xyz, mask, 5, data_chunk=16384)
        np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-5)

    def test_radius_count_exact(self, rng):
        n = 5000
        xyz = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
        mask = jnp.ones(n, dtype=bool)
        cnt = np.asarray(
            search.radius_count_brute(jnp.asarray(xyz), mask, 0.5)
        )
        for q in rng.integers(0, n, 32):
            d2 = np.sum((xyz - xyz[q]) ** 2, axis=1)
            oracle = int(((d2 <= 0.25).sum()) - 1)  # exclude self
            assert cnt[q] == oracle, q

    def test_radius_search_exact_at_100k(self, rng):
        """fixed-capacity radius neighbor-SET query
        (indices + distances) vs a dense numpy oracle at 100K points —
        the library-surface counterpart of nanopcl::KdTree::radius
        (lib/nanoPCL/include/nanopcl/search/kdtree.hpp:20-49)."""
        n = 100_000
        xyz = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
        mask = jnp.asarray(rng.random(n) > 0.05)
        r, cap = 0.9, 16
        idx, dist, cnt = search.radius_search_brute(
            jnp.asarray(xyz), mask, r, cap
        )
        idx, dist, cnt = np.asarray(idx), np.asarray(dist), np.asarray(cnt)
        m = np.asarray(mask)
        for q in rng.integers(0, n, 64):
            d2 = np.sum((xyz - xyz[q]) ** 2, axis=1)
            d2[~m] = np.inf
            d2[q] = np.inf
            inr = np.flatnonzero(d2 <= r * r)
            assert cnt[q] == inr.size, q
            take = min(inr.size, cap)
            oracle = np.sort(np.sqrt(d2[inr]))[:take]
            got = dist[q]
            assert np.all(np.isinf(got[take:])), q
            assert np.all(idx[q, take:] == -1), q
            np.testing.assert_allclose(
                got[:take], oracle, rtol=1e-6, atol=1e-6, err_msg=f"q={q}"
            )
            # Returned indices are a subset of the true in-radius set.
            assert set(idx[q, :take]) <= set(inr.tolist()), q

    def test_radius_search_respects_queries_and_self(self, rng):
        n = 2000
        xyz = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
        mask = jnp.ones(n, dtype=bool)
        # Explicit queries: self-exclusion off (queries aren't cloud members).
        q = xyz[:7] + 1e-4
        idx, dist, cnt = search.radius_search_brute(
            jnp.asarray(xyz), mask, 0.5, 8, queries=jnp.asarray(q),
            exclude_self=False,
        )
        idx, cnt = np.asarray(idx), np.asarray(cnt)
        for i in range(7):
            d2 = np.sum((xyz - q[i]) ** 2, axis=1)
            assert cnt[i] == int((d2 <= 0.25).sum())
            # The near-identical source point must be the first neighbor.
            assert idx[i, 0] == i

    def test_radius_search_cap_exceeding_n(self, rng):
        # max_neighbors > N: capacity clamps then pads back out.
        xyz = rng.uniform(-1, 1, size=(5, 3)).astype(np.float32)
        idx, dist, cnt = search.radius_search_brute(
            jnp.asarray(xyz), jnp.ones(5, bool), 10.0, 9
        )
        assert idx.shape == (5, 9) and dist.shape == (5, 9)
        assert np.all(np.asarray(cnt) == 4)  # everyone minus self
        assert np.all(np.asarray(idx)[:, 4:] == -1)

    def test_sor_stable_at_scale(self, rng):
        """SOR on 80K points: exact path keeps/drops exactly the numpy
        oracle's choices (the round-1 batch-DEM golden attributed its
        0.05 max deviation to approximate-kNN ties here)."""
        from fastdem_tpu.cloud.filters import statistical_outlier_removal
        from fastdem_tpu.cloud.pointcloud import from_numpy

        n = 80_000
        pts = rng.normal(0, 2.0, size=(n, 3)).astype(np.float32)
        pts[:50] *= 10  # gross outliers
        cloud = from_numpy(pts)
        out = statistical_outlier_removal(cloud, k=8, std_mul=1.0)
        kept = np.asarray(out.mask)
        assert kept.sum() < n  # something removed
        assert kept[50:].mean() > 0.9  # inliers mostly kept
        assert kept[:50].mean() < 0.2  # gross outliers mostly dropped


class TestFusedDriver:
    """driver="fused" (one jitted lax.while_loop per align) must agree
    with driver="host" (per-step Python loop) — same math, one dispatch."""

    def make_pair(self, rng):
        n = 4000
        src = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
        # Corrugation in both axes: a smooth tilted plane lets plain ICP
        # slide tangentially (the equivalence check would still pass, but
        # the recovery check needs a well-posed scene).
        src[:, 2] = (
            0.4 * np.sin(1.3 * src[:, 0]) + 0.3 * np.cos(1.7 * src[:, 1])
        )
        from fastdem_tpu.cloud.transform import from_rpy

        T = np.asarray(from_rpy(0.02, -0.01, 0.06, t=(0.25, -0.15, 0.08)))
        tgt = (T[:3, :3] @ src.T).T + T[:3, 3]
        return src, tgt.astype(np.float32), T

    @pytest.mark.parametrize(
        "method,optimizer",
        [("icp", "gn"), ("gicp", "gn"), ("point_to_plane", "gn"),
         ("icp", "lm"), ("vgicp", "lm")],
    )
    def test_fused_matches_host(self, method, optimizer):
        from fastdem_tpu.cloud import registration as reg

        rng = np.random.default_rng(7)
        src, tgt, T_expect = self.make_pair(rng)
        kw = dict(
            method=method, optimizer=optimizer, max_iterations=25,
            voxel_size=0.8,
        )
        r_host = reg.align(pc.from_numpy(src), pc.from_numpy(tgt),
                           driver="host", **kw)
        r_fused = reg.align(pc.from_numpy(src), pc.from_numpy(tgt),
                            driver="fused", **kw)
        assert r_fused.converged == r_host.converged
        assert r_fused.iterations == r_host.iterations
        assert r_fused.num_correspondences == r_host.num_correspondences
        np.testing.assert_allclose(r_fused.T, r_host.T, atol=1e-5)
        np.testing.assert_allclose(
            r_fused.error, r_host.error, rtol=1e-4, atol=1e-7
        )
        # And both recover the applied motion.
        assert np.linalg.norm(r_fused.T[:3, 3] - T_expect[:3, 3]) < 0.08

    def test_unknown_driver_raises(self):
        from fastdem_tpu.cloud import registration as reg

        with pytest.raises(ValueError, match="driver"):
            reg.align(
                pc.from_numpy(np.zeros((10, 3), np.float32)),
                pc.from_numpy(np.zeros((10, 3), np.float32)),
                driver="nope",
            )


def test_vgicp_dense_matches_sorted_correspondence():
    """r5 dense containing-voxel table (arithmetic ids, row gathers) must
    produce the same VGICP solution as the sorted+searchsorted form —
    both partition by the SAME lattice-aligned voxel grid."""
    from fastdem_tpu.cloud import registration as reg
    from fastdem_tpu.cloud.transform import from_rpy

    rng = np.random.default_rng(5)
    src = rng.uniform(-5, 5, (4000, 3)).astype(np.float32)
    src[:, 2] = 0.4 * np.sin(1.3 * src[:, 0]) + 0.3 * np.cos(
        1.7 * src[:, 1]
    )
    T = np.asarray(from_rpy(0.02, -0.01, 0.06, t=(0.25, -0.15, 0.08)))
    tgt = ((T[:3, :3] @ src.T).T + T[:3, 3]).astype(np.float32)
    kw = dict(method="vgicp", optimizer="lm", voxel_size=0.8)
    r_dense = reg.align(
        pc.from_numpy(src), pc.from_numpy(tgt),
        correspondence="dense", **kw,
    )
    r_sorted = reg.align(
        pc.from_numpy(src), pc.from_numpy(tgt),
        correspondence="sorted", **kw,
    )
    assert r_dense.converged and r_sorted.converged
    np.testing.assert_allclose(r_dense.T, r_sorted.T, atol=2e-4)
    assert (
        abs(r_dense.num_correspondences - r_sorted.num_correspondences)
        <= 2
    )
    assert np.linalg.norm(r_dense.T[:3, 3] - T[:3, 3]) < 0.08
    with pytest.raises(ValueError, match="correspondence"):
        reg.align(pc.from_numpy(src), pc.from_numpy(tgt),
                  method="vgicp", correspondence="nope")


def test_align_bucket_knn_prep():
    """GICP with voxel-bucket covariance prep (knn_method="bucket") still
    recovers the motion — the large-N fast path for align's neighbor
    preparation."""
    from fastdem_tpu.cloud import registration as reg
    from fastdem_tpu.cloud.transform import from_rpy

    rng = np.random.default_rng(11)
    src = rng.uniform(-5, 5, (5000, 3)).astype(np.float32)
    src[:, 2] = 0.4 * np.sin(1.3 * src[:, 0]) + 0.3 * np.cos(1.7 * src[:, 1])
    T = np.asarray(from_rpy(0.02, -0.01, 0.05, t=(0.2, -0.1, 0.05)))
    tgt = ((T[:3, :3] @ src.T).T + T[:3, 3]).astype(np.float32)
    res = reg.align(
        pc.from_numpy(src), pc.from_numpy(tgt), method="gicp",
        optimizer="lm", knn_method="bucket", knn_bucket_size=0.5,
    )
    assert res.converged
    assert np.linalg.norm(res.T[:3, 3] - T[:3, 3]) < 0.03
