#!/usr/bin/env python
"""Interactive (per-scan dispatch) streaming throughput, with and without
H2D stage-ahead (double buffering).

The chained-scan bench (bench.py) measures pure device time; production
streaming pays, per scan: host staging + H2D (~12 B/point) + dispatch.
JAX dispatch is async, so issuing scan k+1's device_put while scan k
computes should hide the H2D copy; the staged mode then approaches
device time.

Run: python tools/bench_online.py [--scans 256] [--points 30000]
"""
import argparse
import sys
import time

sys.path.insert(0, ".")

import numpy as np

import jax
import jax.numpy as jnp

from fastdem_tpu import Config, GridGeometry
from fastdem_tpu.mapping.pipeline import build_integrate, create_map_state
from fastdem_tpu.runtime.aotcache import enable_compile_cache


def make_host_scans(K, N, rng):
    ang = rng.uniform(0, 2 * np.pi, (K, N))
    rad = rng.uniform(0.5, 7.2, (K, N))
    z = 0.2 * np.sin(rad) - 1.0
    return np.stack(
        [rad * np.cos(ang), rad * np.sin(ang), z], -1
    ).astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=256)
    ap.add_argument("--points", type=int, default=30000)
    args = ap.parse_args()
    enable_compile_cache()
    print("device:", jax.devices()[0], flush=True)

    geom = GridGeometry.from_length(15.0, 15.0, 0.1)
    cfg = Config()
    cfg.raycasting.enabled = True
    step = build_integrate(geom, cfg, donate=False)
    rng = np.random.default_rng(0)
    scans = make_host_scans(args.scans, args.points, rng)
    mask_host = np.ones(args.points, bool)
    T_bs = jnp.eye(4).at[2, 3].set(1.0)
    T_wb = jnp.eye(4)

    # Warm up (compile) once.
    st0 = create_map_state(geom, cfg)
    out, _ = step(st0, jnp.asarray(scans[0]), jnp.asarray(mask_host), T_bs, T_wb)
    jax.block_until_ready(out.layers)
    mask_dev = jax.device_put(mask_host)

    def run(staged: bool):
        state = create_map_state(geom, cfg)
        jax.block_until_ready(state.layers)
        t0 = time.time()
        if staged:
            nxt = jax.device_put(scans[0])
            for k in range(args.scans):
                cur = nxt
                if k + 1 < args.scans:
                    nxt = jax.device_put(scans[k + 1])  # overlaps compute
                state, _ = step(state, cur, mask_dev, T_bs, T_wb)
        else:
            for k in range(args.scans):
                state, _ = step(
                    state, jnp.asarray(scans[k]), mask_dev, T_bs, T_wb
                )
        jax.block_until_ready(state.layers)
        return (time.time() - t0) / args.scans * 1e3

    for label, staged in (
        ("unstaged #1", False), ("staged  #1", True),
        ("unstaged #2", False), ("staged  #2", True),
    ):
        ms = run(staged)
        print(f"interactive {label}: {ms:7.3f} ms/scan "
              f"({1000.0/ms:6.0f} scans/s)", flush=True)


if __name__ == "__main__":
    main()
