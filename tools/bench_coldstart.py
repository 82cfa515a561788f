#!/usr/bin/env python
"""Cold-vs-warm node start with a program-cache bundle.

Measures time-to-ready (process start -> first scan integrated + first
postprocess pass) twice in fresh subprocesses:

  1. COLD: empty bundle — pays the full XLA backend compile and
     populates the bundle;
  2. WARM: same bundle — compiled executables load from the cache.

The warm number is the deployment story: ship the bundle next to a
checkpoint and a restarted/migrated node is ready in seconds (the
reference C++ node is ready in milliseconds,
ros2/src/fastdem_ros_node.cpp — this is the JAX-world equivalent).

Usage: python tools/bench_coldstart.py [--config PRESET] [--out FILE]
       [--bundle DIR] [--capacity 32768]
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def probe(args):
    """One node-readiness measurement in THIS process. Prints one JSON
    line: seconds from entry to (a) mapper constructed, (b) first scan
    integrated, (c) postprocess pass done."""
    t_start = time.time()
    import numpy as np

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from fastdem_tpu.runtime import aotcache

    aotcache.enable(args.bundle)

    from fastdem_tpu.cloud.pointcloud import from_numpy
    from fastdem_tpu.grid.geometry import GridGeometry
    from fastdem_tpu.mapping.pipeline import FastDEM
    from fastdem_tpu.postprocess import apply_postprocess_fn
    from fastdem_tpu.runtime.node_config import NodeConfig

    cfg = NodeConfig.load(args.config)
    geom = GridGeometry.from_length(
        cfg.map.width, cfg.map.height, cfg.map.resolution
    )
    mapper = FastDEM(geom, cfg.pipeline)
    t_ctor = time.time()

    rng = np.random.default_rng(0)
    n = args.capacity
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(0.5, 7.0, n)
    xyz = np.stack(
        [rad * np.cos(ang), rad * np.sin(ang),
         rng.normal(-2.0, 0.02, n)], -1
    ).astype(np.float32)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    ok = mapper.integrate(
        from_numpy(xyz, frame_id="lidar"), T_bs,
        np.eye(4, dtype=np.float32),
    )
    jax.block_until_ready(mapper.state.layers["elevation"])
    t_scan = time.time()

    fn = jax.jit(apply_postprocess_fn(geom, cfg.postprocess))
    e = mapper.state.layers["elevation"]
    jax.block_until_ready(jax.tree_util.tree_leaves(fn(e, e + 0.1, e - 0.1)))
    t_pp = time.time()

    print(json.dumps({
        "ok": bool(ok),
        "ctor_s": round(t_ctor - t_start, 2),
        "first_scan_s": round(t_scan - t_start, 2),
        "ready_s": round(t_pp - t_start, 2),
    }), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config",
                    default="fastdem_tpu/config/presets/local_mapping.yaml")
    ap.add_argument("--bundle", default="fastdem_bundle")
    ap.add_argument("--capacity", type=int, default=32768)
    ap.add_argument("--out", default=None)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--probe", action="store_true",
                    help="internal: run one readiness probe in-process")
    ap.add_argument("--keep-bundle", action="store_true",
                    help="reuse an existing bundle for the cold leg "
                         "(measures warm-only)")
    args = ap.parse_args()

    if args.probe:
        return probe(args)

    def run_probe(tag, timeout=5400):
        cmd = [sys.executable, __file__, "--probe", "--config", args.config,
               "--bundle", args.bundle, "--capacity", str(args.capacity)]
        if args.platform:
            cmd += ["--platform", args.platform]
        t0 = time.time()
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
        wall = time.time() - t0
        line = next(
            (ln for ln in r.stdout.splitlines() if ln.startswith("{")), None
        )
        if line is None:
            print(f"[{tag}] probe failed:\n{r.stderr[-2000:]}",
                  file=sys.stderr)
            return None
        out = json.loads(line)
        out["wall_s"] = round(wall, 2)
        print(f"[{tag}] {out}", file=sys.stderr)
        return out

    results = {"config": args.config, "capacity": args.capacity,
               "bundle": args.bundle}
    if not args.keep_bundle:
        shutil.rmtree(args.bundle, ignore_errors=True)
        results["cold"] = run_probe("cold")
    results["warm"] = run_probe("warm")
    if results.get("cold") and results.get("warm"):
        results["speedup"] = round(
            results["cold"]["ready_s"] / results["warm"]["ready_s"], 1
        )
    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
