#!/usr/bin/env python
"""nanoPCL-equivalent library-op benchmarks on the accelerator.

The reference publishes op-level numbers for its point-cloud library
(BASELINE.md rows; lib/nanoPCL/README.md:24-32 and
lib/nanoPCL/benchmarks/README.md "Key Results", Intel i7 -O3):

  voxelGrid 500K pts: 12.1 ms    transform 500K pts: 8.5 ms
  normals 100K pts: ~50 ms       ICP 10K/50K/100K: 3/16/54 ms

This tool measures our equivalents so the library surface (not just the
mapping pipeline) has committed numbers against the reference's own table.

Methodology: dense/chainable ops run K dependent iterations inside one
lax.scan and use the shared median-of-pairs two-length estimator
(fastdem_tpu.utils.benchtime) — inputs are CARRY-dependent so XLA cannot
hoist or specialize them (a loop-invariant microbenchmark measures a
hoisted program). Registration reports wall time per align() call (best
of reps, dispatch included).

Usage: python tools/bench_cloud_ops.py [--platform cpu] [--quick]
       [--out FILE.json]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

REF = {  # reference numbers (Intel i7, -O3) for the vs_ref column
    "transform_500k": 8.5,
    "voxelgrid_500k": 12.1,
    "normals_100k": 50.0,
    "knn_100k": None,  # no published standalone kNN row
    "icp_10k": 3.0,
    "vgicp_50k": 16.0,   # reference row is KdTree ICP; see note
    "vgicp_100k": 54.0,  # reference row is KdTree ICP; see note
}


def make_cloud_np(n, rng, spread=20.0):
    xyz = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    xyz[:, 2] = (0.1 * np.sin(xyz[:, 0]) + 0.02 * rng.normal(size=n)).astype(
        np.float32
    )
    return xyz


def chain(body, init, K, pairs=8):
    """Two-length difference over a K/2K lax.scan of ``body`` (carry-
    dependent: body(carry, i) -> carry)."""
    import jax

    from fastdem_tpu.utils.benchtime import two_length_diff_ms

    def run(length):
        @jax.jit
        def f(c):
            out, _ = jax.lax.scan(
                lambda c, i: (body(c, i), ()), c,
                jax.numpy.arange(length),
            )
            return out

        return f

    f1, f2 = run(K), run(2 * K)
    t0 = time.time()
    jax.block_until_ready(f1(init))
    jax.block_until_ready(f2(init))
    compile_s = time.time() - t0
    ms, per_pair, _ = two_length_diff_ms(
        lambda: jax.block_until_ready(f1(init)),
        lambda: jax.block_until_ready(f2(init)),
        K, pairs=pairs,
    )
    return ms, per_pair, compile_s


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="smaller sizes / fewer pairs (CI smoke)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--sections", default=None, metavar="A,B",
                    help="run only these sections (transform,voxel,knn,"
                         "knn_grid,radius_grid,knn_bucket,normals,"
                         "normals_grid,normals_bucket,reg)")
    args = ap.parse_args()

    sections = set(args.sections.split(",")) if args.sections else None

    def want(name):
        return sections is None or name in sections

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from fastdem_tpu.runtime.aotcache import enable_compile_cache

    enable_compile_cache()
    print(f"device: {jax.devices()[0]}", file=sys.stderr)

    import dataclasses

    import jax.numpy as jnp

    from fastdem_tpu.cloud import filters, normals, registration
    from fastdem_tpu.cloud.pointcloud import from_numpy
    from fastdem_tpu.cloud.search import knn_brute
    from fastdem_tpu.cloud.transform import from_rpy, transform_points

    q = args.quick
    rng = np.random.default_rng(0)
    rows = []

    def emit(name, ms, note=None):
        ref = REF.get(name)
        row = {"config": name, "ms": round(ms, 4)}
        if ref:
            row["ref_ms_i7"] = ref
            row["vs_ref"] = round(ref / ms, 2)
        if note:
            row["note"] = note
        rows.append(row)
        vs = f"  ({ref / ms:5.1f}x vs reference {ref} ms)" if ref else ""
        print(f"{name:>16}: {ms:8.3f} ms{vs}", file=sys.stderr)
        print("BENCHCFG " + json.dumps(row), flush=True)

    # --- transform 500K: K dependent rigid transforms of a carried cloud.
    n = 50000 if q else 500000
    if want("transform"):
        xyz0 = jnp.asarray(make_cloud_np(n, rng))
        T_step = jnp.asarray(
            from_rpy(0.001, 0.002, 0.003, t=(0.01, 0.02, 0.0))
        )

        def t_body(xyz, i):
            return transform_points(xyz, T_step)

        ms, _, _ = chain(t_body, xyz0, K=32 if q else 256,
                         pairs=4 if q else 8)
        emit("transform_500k" if not q else "transform_50k", ms)

    # --- voxelGrid 500K (ANY mode, like the pipeline's raycast downsample;
    # sort-based; the carried offset makes every iteration's keys fresh).
    cloud500 = from_numpy(make_cloud_np(n, rng)) if want("voxel") else None

    def v_body(carry, i):
        xyz, mask = carry
        c = dataclasses.replace(cloud500, xyz=xyz, mask=mask)
        out = filters.voxel_grid(c, 0.2, mode=filters.VoxelMode.ANY)
        # Data-dependent feedback: shift by a function of the survivor count
        # so the next iteration's voxel keys cannot be hoisted.
        cnt = jnp.sum(out.mask.astype(jnp.float32))
        return (xyz + 1e-4 * jnp.sin(cnt) + 1e-3, mask), ()

    def v_body2(carry, i):
        c, _ = v_body(carry, i)
        return c

    if want("voxel"):
        ms, _, _ = chain(v_body2, (cloud500.xyz, cloud500.mask),
                         K=8 if q else 32, pairs=4 if q else 8)
        emit("voxelgrid_500k" if not q else "voxelgrid_50k", ms)

    # --- kNN + normals at 100K (exact doubly-tiled matmul kNN).
    n2 = 10000 if q else 100000
    xyz1 = jnp.asarray(make_cloud_np(n2, rng, spread=10.0))
    mask1 = jnp.ones(n2, dtype=bool)

    def k_body(xyz, i):
        idx, dist = knn_brute(xyz, mask1, k=10)
        # Feedback through the result (mean neighbor distance) — keeps the
        # chain dependent without changing the geometry meaningfully.
        return xyz + 1e-6 * jnp.mean(jnp.where(
            jnp.isfinite(dist), dist, 0.0)), ()

    def k_body2(xyz, i):
        return k_body(xyz, i)[0]

    if want("knn"):
        ms, _, _ = chain(k_body2, xyz1, K=2 if q else 4,
                         pairs=3 if q else 6)
        emit("knn_100k" if not q else "knn_10k", ms,
             note="exact brute-force kNN k=10 incl. re-rank "
                  "(reference has no standalone kNN row)")

    cloudn = from_numpy(np.asarray(xyz1))

    if want("knn_grid"):
        # The exact sub-quadratic default (search.knn_grid): dense-grid
        # column candidates + certificate, brute fallback on failures.
        # Host-driven (the certificate is a host decision), so this is
        # honest WALL time per call — directly comparable to nanoflann's
        # host query loop, not a chained device number.
        from fastdem_tpu.cloud.search import _auto_bucket_size, knn_grid
        from fastdem_tpu.utils.benchtime import summarize

        # Bucket side auto-sampled ONCE (1.2x p90 kth distance) — a
        # per-sensor tunable, like choosing a voxel size; the timed call
        # still includes the full grid BUILD (sort + CSR) and the brute
        # fallback for certificate failures.
        bsize = _auto_bucket_size(xyz1, mask1, 10)
        knn_grid(xyz1, mask1, 10, bucket_size=bsize)  # warm (compiles)
        times = []
        for _ in range(3 if q else 5):
            t0 = time.time()
            idx, dist = knn_grid(xyz1, mask1, 10, bucket_size=bsize)
            idx.block_until_ready()
            times.append((time.time() - t0) * 1e3)
        st = summarize(times)
        emit("knn_100k_grid" if not q else "knn_10k_grid", st["median"],
             note=f"EXACT dense-grid kNN k=10 wall ms/call incl. grid "
                  f"build + certificate fallback, median of {st['n']} "
                  f"reps +-{st['ci95']:.1f} CI95, bucket {bsize:.3f} m "
                  f"(reference has no standalone kNN row)")

    if want("normals_grid"):
        from fastdem_tpu.cloud.search import _auto_bucket_size
        from fastdem_tpu.utils.benchtime import summarize

        bsize_n = _auto_bucket_size(xyz1, mask1, 10)

        def normals_grid_once():
            c = dataclasses.replace(cloudn, xyz=xyz1)
            out = normals.estimate_normals(
                c, k=10, method="grid", bucket_size=bsize_n
            )
            out.channels["normal"].block_until_ready()

        normals_grid_once()  # warm
        times = []
        for _ in range(3 if q else 5):
            t0 = time.time()
            normals_grid_once()
            times.append((time.time() - t0) * 1e3)
        st = summarize(times)
        REF["normals_100k_grid"] = REF["normals_100k"]
        emit(
            "normals_100k_grid" if not q else "normals_10k_grid",
            st["median"],
            note=f"EXACT grid-kNN + PCA normals wall ms/call, median of "
                 f"{st['n']} reps +-{st['ci95']:.1f} CI95 (nanoPCL "
                 f"estimateNormals ~50 ms at 100K)",
        )

    if want("radius_grid"):
        from fastdem_tpu.cloud.search import radius_search_grid
        from fastdem_tpu.utils.benchtime import summarize

        radius_search_grid(xyz1, mask1, 0.5, 16)  # warm
        times = []
        for _ in range(3 if q else 5):
            t0 = time.time()
            ri, rd, rc = radius_search_grid(xyz1, mask1, 0.5, 16)
            ri.block_until_ready()
            times.append((time.time() - t0) * 1e3)
        st = summarize(times)
        emit("radius_100k_grid" if not q else "radius_10k_grid",
             st["median"],
             note=f"EXACT radius SET retrieval r=0.5 m cap 16 wall "
                  f"ms/call incl. grid build, median of {st['n']} reps "
                  f"+-{st['ci95']:.1f} CI95 (dense-table; the cap-pass "
                  f"extraction dominates — counts are the cheap case "
                  f"below; brute tile is O(N^2))")

        # Count-only (what radius_outlier_removal consumes): cap=1 ->
        # one extraction pass; the dense count sweep is the whole cost.
        radius_search_grid(xyz1, mask1, 0.5, 1)  # warm
        times = []
        for _ in range(3 if q else 5):
            t0 = time.time()
            _, _, rc = radius_search_grid(xyz1, mask1, 0.5, 1)
            rc.block_until_ready()
            times.append((time.time() - t0) * 1e3)
        st = summarize(times)
        emit("radius_count_100k_grid" if not q else "radius_count_10k",
             st["median"],
             note=f"EXACT in-radius counts r=0.5 m wall ms/call incl. "
                  f"grid build, median of {st['n']} reps "
                  f"+-{st['ci95']:.1f} CI95")

        # The tiled direct-difference BRUTE count — the production
        # default for counting (filters.radius_outlier_removal): pure
        # dense elementwise work, no candidate extraction. device_get
        # fences each call.
        from fastdem_tpu.cloud.search import radius_count_brute

        fb = jax.jit(
            radius_count_brute,
            static_argnames=(
                "radius", "exclude_self", "chunk", "data_chunk",
            ),
        )
        float(jax.device_get(fb(xyz1, mask1, 0.5)[0]))  # warm
        times = []
        for _ in range(3 if q else 5):
            t0 = time.time()
            float(jax.device_get(fb(xyz1, mask1, 0.5)[0]))
            times.append((time.time() - t0) * 1e3)
        st = summarize(times)
        emit(
            "radius_count_100k_brute" if not q else "radius_count_10k_b",
            st["median"],
            note=f"EXACT in-radius counts r=0.5 m, tiled brute "
                 f"(O(N^2) dense, the production default), wall ms/call "
                 f"median of {st['n']} reps +-{st['ci95']:.1f} CI95",
        )

    if want("knn_bucket"):
        # The latency-bound alternative: voxel-bucket kNN (27-neighborhood
        # candidates, approximate on bucket overflow) — the right tool at
        # 100K, where exact-any-N pays ~N^2 top-k merge work.
        from fastdem_tpu.cloud.search import knn as knn_any

        def kb_body(xyz, i):
            idx, dist = knn_any(xyz, mask1, 10, method="bucket",
                                bucket_size=0.3)
            return xyz + 1e-6 * jnp.mean(jnp.where(
                jnp.isfinite(dist), dist, 0.0)), ()

        def kb_body2(xyz, i):
            return kb_body(xyz, i)[0]

        ms, _, _ = chain(kb_body2, xyz1, K=2 if q else 4,
                         pairs=3 if q else 6)
        emit("knn_100k_bucket" if not q else "knn_10k_bucket", ms,
             note="voxel-bucket kNN k=10 (approximate on bucket "
                  "overflow; per_bucket=8, bucket 0.3 m)")

    def n_body(xyz, i):
        c = dataclasses.replace(cloudn, xyz=xyz)
        out = normals.estimate_normals(c, k=10)
        nrm = out.channels["normal"]
        return xyz + 1e-6 * nrm, ()

    def n_body2(xyz, i):
        return n_body(xyz, i)[0]

    if want("normals"):
        ms, _, _ = chain(n_body2, xyz1, K=2 if q else 4,
                         pairs=3 if q else 6)
        emit("normals_100k" if not q else "normals_10k", ms,
             note="kNN k=10 + PCA normal per point (nanoPCL "
                  "estimateNormals)")

    if want("normals_bucket"):
        def nb_body(xyz, i):
            c = dataclasses.replace(cloudn, xyz=xyz)
            out = normals.estimate_normals(c, k=10, method="bucket",
                                           bucket_size=0.3)
            return xyz + 1e-6 * out.channels["normal"], ()

        def nb_body2(xyz, i):
            return nb_body(xyz, i)[0]

        ms, _, _ = chain(nb_body2, xyz1, K=2 if q else 4,
                         pairs=3 if q else 6)
        emit("normals_100k_bucket" if not q else "normals_10k_bucket", ms,
             note="bucket-kNN + PCA normal per point")

    # --- Registration ladder. Dense exact ICP at 10K; VGICP (voxelized
    # Gaussian correspondences — the large-N path) at
    # 50K/100K, where nanoPCL's number is KdTree point-to-point ICP.
    def reg(nn, method, name):
        if q:
            nn, name = 2000, f"{method}_2k_quick"
        src = make_cloud_np(nn, rng, spread=10.0)
        T_true = from_rpy(0.01, -0.02, 0.05, t=(0.3, -0.2, 0.1))
        tgt = (np.asarray(T_true[:3, :3]) @ src.T).T + np.asarray(
            T_true[:3, 3]
        )
        s, t = from_numpy(src), from_numpy(tgt.astype(np.float32))
        # LM terminates decisively (accept-only steps; plain GN oscillates
        # at the strict eps on this corrugated scene); exact grid-kNN prep
        # for the distribution methods — the brute any-N kNN's ~N^2 top-k
        # merges would otherwise dominate the align wall time at 50K+.
        kw = dict(method=method, optimizer="lm")
        if method == "vgicp":
            kw["voxel_size"] = 1.0
            kw["knn_method"] = "grid"
        from fastdem_tpu.utils.benchtime import summarize

        res = registration.align(s, t, **kw)  # warm (compile)
        times = []
        for _ in range(3 if q else 5):
            t0 = time.time()
            res = registration.align(s, t, **kw)
            times.append((time.time() - t0) * 1e3)
        st = summarize(times)
        err = float(np.linalg.norm(
            np.asarray(res.T)[:3, 3] - np.asarray(T_true[:3, 3])
        ))
        # Device-only solve time: chain TWO whole-align programs on
        # pre-staged problems inside one jit (the second align's init is
        # perturbed by the first's result, so it cannot be hoisted) and
        # difference against the single-align program — cancels the
        # per-dispatch host cost, like every pipeline row. The wall
        # median above carries the dispatch cost plus prep.
        dev_ms = None
        try:
            import jax
            import jax.numpy as jnp

            from fastdem_tpu.cloud.registration import (
                _fused_driver_cached,
            )
            from fastdem_tpu.utils.benchtime import two_length_diff_ms

            from fastdem_tpu.cloud import normals as nrm
            from fastdem_tpu.cloud.registration import (
                segal_regularize,
                voxel_distribution_table,
            )

            t_normals = jnp.zeros_like(t.xyz)
            s_cov = jnp.zeros((s.capacity, 3, 3), jnp.float32)
            t_cov = jnp.zeros((t.capacity, 3, 3), jnp.float32)
            t_xyz, t_mask = t.xyz, t.mask
            vox_keys = jnp.zeros(1, jnp.int32)
            corr, corr_dims, vsize = "nearest", None, 0.5
            if method == "vgicp":
                s2 = nrm.estimate_covariances(s, k=10, method="grid")
                s_cov = s2.channels["covariance"]
                # Mirror align()'s DENSE default correspondence.
                ov, dv, vm, vc, vv, vsize = voxel_distribution_table(
                    t, kw["voxel_size"]
                )
                t_xyz, t_mask = vm, vv
                vox_keys = jnp.asarray(ov)
                corr, corr_dims = "voxel_dense", dv
                t_cov = jnp.where(
                    vv[:, None, None], segal_regularize(vc, 1e-3),
                    jnp.eye(3, dtype=jnp.float32),
                )
            run = _fused_driver_cached(
                "lm", "gicp" if method == "vgicp" else method, "none",
                1.0, 1.0, corr, vsize, 50, 1e-4, 1e-4, 1e-3, 10.0,
                10, 1e-6, 10, corr_dims,
            )
            a = (s.xyz, s.mask, t_xyz, t_mask, t_normals, s_cov, t_cov,
                 vox_keys)
            T0 = jnp.eye(4, dtype=jnp.float32)

            @jax.jit
            def once(T0):
                T, *_ = run(T0, *a)
                return T

            @jax.jit
            def twice(T0):
                T, *_ = run(T0, *a)
                # Second solve from a perturbed init derived from the
                # first's result — a real dependent second align.
                T2, *_ = run(T0.at[0, 3].add(T[0, 3] * 1e-3), *a)
                return T + T2

            jax.block_until_ready(once(T0))
            jax.block_until_ready(twice(T0))
            dev_ms, _, _ = two_length_diff_ms(
                lambda: jax.block_until_ready(once(T0)),
                lambda: jax.block_until_ready(twice(T0)),
                1, pairs=5,
            )
        except Exception as e:  # noqa: BLE001
            print(f"[{name}] device-time chain skipped: {e}",
                  file=sys.stderr)
        extra = (f", device-only solve {dev_ms:.1f} ms/align"
                 if dev_ms else "")
        emit(name, st["median"],
             note=f"wall time/align (fused one-dispatch LM solve + neighbor prep), "
                  f"median of {st['n']} reps +-{st['ci95']:.1f} CI95, "
                  f"{res.iterations} iters, converged={bool(res.converged)}, "
                  f"t_err={err:.4f} m{extra}"
             + (" ; reference row is KdTree ICP" if method == "vgicp"
                else ""))
        if dev_ms:
            row = {
                "config": f"{name}_device_only", "ms": round(dev_ms, 3),
                "note": "two-align-chain difference: device solve time "
                        "per align excl. host dispatch (co-located "
                        "serving figure)",
            }
            rows.append(row)
            print("BENCHCFG " + json.dumps(row), flush=True)

    if want("reg"):
        reg(10000, "icp", "icp_10k")
        if not q:
            reg(50000, "vgicp", "vgicp_50k")
            reg(100000, "vgicp", "vgicp_100k")

    if args.out:
        with open(args.out, "w") as f:
            json.dump({
                "device": str(jax.devices()[0]),
                "reference": "nanoPCL op table, Intel i7 -O3 "
                             "(BASELINE.md; lib/nanoPCL/README.md:24-32)",
                "configs": rows,
            }, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
