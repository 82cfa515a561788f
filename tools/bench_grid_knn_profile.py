#!/usr/bin/env python
"""Stage-level profile of the DenseGrid kNN pass (chained, dispatch-
cancelled). Finds where the 100K-point grid kNN's time goes:
build (sort+CSR), candidate slice-gathers, distance+reduction, or the
final order gather.

Each variant chains K dependent iterations of a jitted body over the
same cloud (carry perturbs the query coords so nothing hoists) and uses
the two-length difference estimator.

Usage: python tools/bench_grid_knn_profile.py [--n 100000] [--platform cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--cap", type=int, default=64)
    ap.add_argument("--chain", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    print(f"device: {jax.devices()[0]}", file=sys.stderr)

    import jax.numpy as jnp

    from fastdem_tpu.cloud import search
    from fastdem_tpu.utils.benchtime import two_length_diff_ms

    rng = np.random.default_rng(0)
    n = args.n
    xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    xyz[:, 2] = (0.1 * np.sin(xyz[:, 0])
                 + 0.02 * rng.normal(size=n)).astype(np.float32)
    xyzj = jnp.asarray(xyz)
    maskj = jnp.ones(n, bool)
    b = search._auto_bucket_size(xyzj, maskj, args.k)
    b, dims, origin = search._grid_geometry(xyzj, maskj, b, 4_000_000)
    originj = jnp.asarray(origin)
    print(f"bucket {b:.3f} dims {dims}", file=sys.stderr)

    results = {}

    def chain(label, body):
        def run(length):
            @jax.jit
            def f(x):
                def step(c, _):
                    return body(c), ()

                o, _ = jax.lax.scan(step, x, None, length=length)
                return o

            return f

        f1, f2 = run(args.chain), run(2 * args.chain)
        t0 = time.time()
        jax.block_until_ready(f1(xyzj))
        jax.block_until_ready(f2(xyzj))
        comp = time.time() - t0
        ms, _, _ = two_length_diff_ms(
            lambda: jax.block_until_ready(f1(xyzj)),
            lambda: jax.block_until_ready(f2(xyzj)),
            args.chain, pairs=args.pairs,
        )
        print(f"{label:>28s}: {ms:9.3f} ms/iter (compile {comp:.0f}s)",
              flush=True)
        results[label] = round(ms, 3)

    def build_grid(x):
        return search.DenseGrid(
            x, maskj, b, dims=dims, origin=originj
        )

    # 1. build only: sort + CSR + inverse permutation.
    def body_build(x):
        g = build_grid(x)
        return x + 1e-7 * g.sorted_xyz[0, 0] + 1e-7 * jnp.float32(
            g.starts[-1]
        )

    chain("build (sort+CSR)", body_build)

    # 2. full pass (build + query all N).
    def body_full(x):
        g = build_grid(x)
        idx, dist, exact = g.knn(x, args.k, cap=args.cap,
                                 self_pos=g.inv_order)
        return x + 1e-7 * jnp.where(
            jnp.isfinite(dist[:, :1]), dist[:, :1], 0.0
        )

    chain("full pass (slice-gather)", body_full)

    # 2b. dense-table self-kNN (the r5 formulation).
    def body_table(x):
        g = build_grid(x)
        idx, dist, exact = g.knn_table(args.k, m=32)
        return x + 1e-7 * jnp.where(
            jnp.isfinite(dist[:, :1]), dist[:, :1], 0.0
        )

    chain("full pass (dense table)", body_table)

    # 3. candidates only: slices fetched + summed densely (no top-k, no
    # order gather).
    def body_cand(x):
        g = build_grid(x)
        nz = dims[2]
        capc = args.cap
        pad_xyz = jnp.concatenate(
            [g.sorted_xyz, jnp.full((capc, 3), 1e9, jnp.float32)]
        )
        qc = g._coords(x)
        base_key = g._key(qc)
        acc = jnp.zeros((n,), jnp.float32)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                ck = base_key + (dx * dims[1] + dy) * nz - 1
                start = g.starts[ck]
                pts = jax.vmap(
                    lambda s: jax.lax.dynamic_slice(
                        pad_xyz, (s, 0), (capc, 3)
                    )
                )(start)
                acc = acc + jnp.sum(pts, axis=(1, 2))
        return x + 1e-12 * acc[:, None]

    chain("build + 9 slice fetches", body_cand)

    # 4. distances without fetch: same shapes from broadcasted dummy data.
    def body_dist(x):
        g = build_grid(x)
        capc = args.cap
        qc = g._coords(x)
        acc = jnp.zeros((n,), jnp.float32)
        fake = jnp.broadcast_to(
            x[:1, None, :], (n, capc, 3)
        ) + qc[:, :1, None].astype(jnp.float32)
        for i in range(9):
            d2 = jnp.sum(
                (fake + jnp.float32(i) - x[:, None, :]) ** 2, axis=-1
            )
            acc = acc + jnp.min(d2, axis=1)
        return x + 1e-12 * acc[:, None]

    chain("build + dense dist (no fetch)", body_dist)

    print("GRIDPROFILE " + json.dumps(
        {"n": n, "cap": args.cap, "dims": list(dims), **results}
    ))


if __name__ == "__main__":
    main()
