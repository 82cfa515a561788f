#!/usr/bin/env python
"""Sharded-vs-unsharded throughput A/B on a single-device mesh.

With the shard_map windowed formulation (per-device window intersection
and polar field) the sharded path should cost about the same as the
unsharded windowed path on ONE device — multi-device maps keep the
windowed O(range^2) update. Both programs run in one process, chained
K/2K scans, median-of-pairs two-length estimator.

Usage: python tools/bench_sharded_ab.py [--scans K] [--points N]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def make_inputs(K, N, rng, spread):
    import jax.numpy as jnp

    ang = rng.uniform(0, 2 * np.pi, (K, N))
    rad = rng.uniform(0.5, spread, (K, N))
    x = rad * np.cos(ang)
    y = rad * np.sin(ang)
    z = 0.2 * np.sin(0.8 * x) * np.cos(0.6 * y) - 1.0 + rng.normal(
        0, 0.02, (K, N)
    )
    xyz = jnp.asarray(np.stack([x, y, z], -1).astype(np.float32))
    mask = jnp.ones((K, N), bool)
    T_wb = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    T_wb[:, 0, 3] = np.cumsum(rng.normal(0, 0.05, K)).astype(np.float32)
    return xyz, mask, jnp.asarray(T_wb)


def measure(seq, state, inputs1, inputs2, T_bs, K, pairs=8):
    import jax

    from fastdem_tpu.utils.benchtime import two_length_diff_ms

    def run_k():
        jax.block_until_ready(
            seq(state, *inputs1[:2], T_bs, inputs1[2]).layers
        )

    def run_2k():
        jax.block_until_ready(
            seq(state, *inputs2[:2], T_bs, inputs2[2]).layers
        )

    run_k()  # warm (compile)
    run_2k()
    ms, _, _ = two_length_diff_ms(run_k, run_2k, K, pairs=pairs)
    return ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=16)
    ap.add_argument("--points", type=int, default=30000)
    ap.add_argument("--map", type=float, default=200.0)
    ap.add_argument("--range", type=float, default=20.0, dest="rng_max")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--gspmd", action="store_true",
                    help="also measure the GSPMD full-map fallback "
                         "(window_update=False, xla polar) — the path the "
                         "sharded builders used before round 3")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from fastdem_tpu.runtime.aotcache import enable_compile_cache

    enable_compile_cache()
    print(f"device: {jax.devices()[0]}", file=sys.stderr)

    import jax.numpy as jnp

    from fastdem_tpu import Config, GridGeometry
    from fastdem_tpu.config.config import MappingMode
    from fastdem_tpu.mapping.pipeline import (
        build_integrate_sequence,
        create_map_state,
    )
    from fastdem_tpu.parallel import sharding as sh

    geom = GridGeometry.from_length(args.map, args.map, 0.1)
    cfg = Config()
    cfg.mapping.mode = MappingMode.GLOBAL
    cfg.raycasting.enabled = True
    cfg.point_filter.range_max = args.rng_max

    K = args.scans
    rng = np.random.default_rng(0)
    inputs1 = make_inputs(K, args.points, rng, spread=18.0)
    inputs2 = tuple(
        jnp.concatenate([a, a]) for a in inputs1
    )
    T_bs = jnp.eye(4).at[2, 3].set(1.0)
    state = create_map_state(geom, cfg)

    t0 = time.time()
    seq_u = build_integrate_sequence(geom, cfg, jit=True, donate=False)
    ms_u = measure(seq_u, state, inputs1, inputs2, T_bs, K)
    print(f"unsharded windowed: {ms_u:7.3f} ms/scan "
          f"(incl. compile {time.time() - t0:.0f}s)", file=sys.stderr)

    mesh = sh.make_mesh()
    t0 = time.time()
    seq_s, shard = sh.build_sharded_integrate_sequence(
        geom, cfg, mesh, donate=False
    )
    ms_s = measure(seq_s, shard(state), inputs1, inputs2, T_bs, K)
    print(f"sharded (mesh {dict(mesh.shape)}): {ms_s:7.3f} ms/scan "
          f"(incl. compile {time.time() - t0:.0f}s)", file=sys.stderr)

    out = {
        "config": "global_200m_raycast_sharded_ab",
        "mesh": list(mesh.devices.shape),
        "ms_unsharded": round(ms_u, 4),
        "ms_sharded": round(ms_s, 4),
        "sharded_over_unsharded": round(ms_s / ms_u, 3),
    }

    if args.gspmd:
        t0 = time.time()
        seq_g, shard_g = sh.build_sharded_integrate_sequence(
            geom, cfg, mesh, donate=False, window_update=False,
        )
        ms_g = measure(seq_g, shard_g(state), inputs1, inputs2, T_bs, K)
        print(f"sharded GSPMD full-map fallback: {ms_g:7.3f} ms/scan "
              f"(incl. compile {time.time() - t0:.0f}s)", file=sys.stderr)
        out["ms_sharded_gspmd_fallback"] = round(ms_g, 4)
        out["shardmap_speedup_vs_fallback"] = round(ms_g / ms_s, 3)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
