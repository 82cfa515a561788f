#!/usr/bin/env python
"""fastdem_replay: batched offline mapping over a recorded scan sequence.

The reference's offline workflow replays a rosbag into fastdem_node — one
host call per scan. Each dispatch pays a fixed host cost, so this tool
stages scans in device memory and integrates them K frames per device
program
(fastdem_tpu.mapping.pipeline.build_integrate_sequence): the map-state
result matches the one-scan-at-a-time path exactly on every decision
layer (see build_integrate_sequence's docstring), at batched throughput.

Scan sources (same conventions as tools/fastdem_node.py):
  --synthetic N           N synthetic VLP-16-like scans with a wandering pose
  --scans DIR             directory of .pcd / .bin files (sorted), with
  --trajectory FILE       a TUM (timestamp tx ty tz qx qy qz qw) or KITTI
                          (12-float 3x4) trajectory supplying T_world_base

Outputs: final map as npz (+ optional PNG layers) under --out, and a
throughput line (scans/s, ms/scan) on stderr.

Usage:
  python tools/fastdem_replay.py --config fastdem_tpu/config/presets/local_mapping.yaml \
      --synthetic 64 --batch 16 --out fastdem_replay [--platform cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from fastdem_node import file_scans, synthetic_scans  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--scans", default=None)
    ap.add_argument("--trajectory", default=None)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default="fastdem_replay")
    ap.add_argument("--png", action="store_true",
                    help="also render elevation/variance PNGs")
    ap.add_argument("--sensor-height", type=float, default=1.0,
                    help="sensor z offset in the base frame (T_base_sensor)")
    ap.add_argument("--resume", default=None,
                    help="npz checkpoint to continue mapping from (same "
                         "geometry; estimator state round-trips losslessly)")
    ap.add_argument("--prefetch", type=int, default=0,
                    help="stream scans through the native prefetching "
                         "loader with N parser threads (overlaps file "
                         "parsing with device compute; --scans only)")
    ap.add_argument("--capacity", type=int, default=32768,
                    help="point capacity per scan in prefetch mode "
                         "(larger scans are truncated)")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--program-cache", default=None, metavar="DIR",
                    help="program-cache bundle (runtime/aotcache.py): load "
                         "compiled executables from DIR instead of paying "
                         "first-run XLA compiles; build with "
                         "tools/aot_warmup.py (default: the compile "
                         "cache of runtime/aotcache.py)")
    args = ap.parse_args()

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    from fastdem_tpu.runtime import aotcache

    if args.program_cache:
        aotcache.enable(args.program_cache)
    else:
        aotcache.enable_compile_cache()

    from fastdem_tpu.cloud.pointcloud import from_numpy
    from fastdem_tpu.grid.geometry import GridGeometry
    from fastdem_tpu.io.npz import save_npz
    from fastdem_tpu.mapping.pipeline import FastDEM
    from fastdem_tpu.runtime.node_config import NodeConfig

    try:
        node_cfg = NodeConfig.load(args.config)
    except OSError as e:
        print(
            f"error: cannot read config '{args.config}': {e} "
            "(presets live in fastdem_tpu/config/presets/)",
            file=sys.stderr,
        )
        return 2
    geom = GridGeometry.from_length(
        node_cfg.map.width, node_cfg.map.height, node_cfg.map.resolution
    )
    mapper = FastDEM(geom, node_cfg.pipeline)
    if args.resume:
        import jax.numpy as jnp

        from fastdem_tpu.grid.gridmap import GridMapState
        from fastdem_tpu.io.npz import load_npz
        from fastdem_tpu.mapping.pipeline import initial_layer_fills

        g2, st, _meta = load_npz(args.resume)
        if (g2.rows, g2.cols) != (geom.rows, geom.cols) or abs(
            g2.resolution - geom.resolution
        ) > 1e-9:
            print(
                f"error: checkpoint geometry {g2.rows}x{g2.cols}@"
                f"{g2.resolution} != config {geom.rows}x{geom.cols}@"
                f"{geom.resolution}",
                file=sys.stderr,
            )
            return 2
        # Exists-guarded layer merge (the reference's ensureLayers): a
        # checkpoint from a different pipeline config gains the missing
        # layers at their initial fills.
        lyr = dict(st.layers)
        for name, fill in initial_layer_fills(node_cfg.pipeline).items():
            if name not in lyr:
                lyr[name] = jnp.full(geom.shape, fill, dtype=jnp.float32)
        mapper.state = GridMapState(layers=lyr, position=st.position)
        print(f"[fastdem_replay] resumed from {args.resume}", file=sys.stderr)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = args.sensor_height

    if args.prefetch > 0:
        if not args.scans:
            raise SystemExit("--prefetch requires --scans DIR")
        return run_prefetch(args, geom, mapper, T_bs)

    if args.synthetic:
        source = synthetic_scans(args.synthetic)
    elif args.scans:
        source = file_scans(args.scans, args.trajectory)
    else:
        raise SystemExit("provide --synthetic N or --scans DIR")

    clouds, poses = [], []
    for xyz, T_wb, t_ns in source:
        clouds.append(from_numpy(xyz, timestamp_ns=t_ns))
        poses.append(T_wb)
    if not clouds:
        raise SystemExit("no scans to replay")
    poses = np.stack(poses).astype(np.float32)

    # Warm-up (excludes compile from the timing) on the LARGEST cloud so
    # the compiled (batch, capacity) program matches the full sequence —
    # a bigger cloud later would otherwise recompile inside the timed
    # loop. Then restore the pre-warm-up map (fresh, or the --resume
    # checkpoint).
    state0 = mapper.state
    k0 = min(args.batch, len(clouds))
    bigi = max(range(len(clouds)), key=lambda i: clouds[i].capacity)
    big = clouds[bigi]
    mapper.integrate_sequence(
        [big] * k0, T_bs, np.repeat(poses[bigi : bigi + 1], k0, 0),
        batch=args.batch,
    )
    import jax

    jax.block_until_ready(mapper.state.layers)
    mapper.state = state0

    t0 = time.time()
    n = mapper.integrate_sequence(clouds, T_bs, poses, batch=args.batch)
    jax.block_until_ready(mapper.state.layers)
    dt = time.time() - t0
    print(
        f"[fastdem_replay] {n} scans in {dt*1e3:.1f} ms "
        f"({n/dt:.0f} scans/s, {dt/max(n,1)*1e3:.3f} ms/scan, "
        f"batch={args.batch})",
        file=sys.stderr,
    )

    save_artifacts(args, geom, mapper)


def save_artifacts(args, geom, mapper):
    from fastdem_tpu.io.npz import save_npz

    os.makedirs(args.out, exist_ok=True)
    out_npz = os.path.join(args.out, "map.npz")
    save_npz(out_npz, geom, mapper.state, frame_id=mapper.frame_id)
    print(f"[fastdem_replay] map -> {out_npz}", file=sys.stderr)
    if args.png:
        from fastdem_tpu.io.png import save_png

        for layer in ("elevation", "variance"):
            if layer in mapper.state.layers:
                p = os.path.join(args.out, f"{layer}.png")
                if save_png(p, mapper.state, layer):
                    print(f"[fastdem_replay] {layer} -> {p}", file=sys.stderr)


def run_prefetch(args, geom, mapper, T_bs):
    """Streaming replay: the native ScanStream parses files with a worker
    pool while the device integrates the previous chunk — wall time is
    max(parse, compute) instead of their sum, and memory stays at one
    chunk of scans regardless of sequence length."""
    import glob as globmod

    import jax
    import jax.numpy as jnp

    from fastdem_tpu import native
    from fastdem_tpu.io.pcd import load_trajectory
    from fastdem_tpu.mapping.pipeline import build_integrate_sequence

    files = sorted(
        globmod.glob(os.path.join(args.scans, "*.pcd"))
        + globmod.glob(os.path.join(args.scans, "*.bin"))
    )
    if not files:
        raise SystemExit(f"no .pcd/.bin scans in {args.scans}")
    poses = None
    if args.trajectory:
        _, poses = load_trajectory(args.trajectory)

    K, cap = args.batch, args.capacity
    seq = build_integrate_sequence(geom, mapper.cfg, donate=True)
    state = mapper.state
    eye = np.eye(4, dtype=np.float32)
    tbs_j = jnp.asarray(T_bs)

    # Compile outside the timed loop. All-empty frames touch no layers,
    # and using the CURRENT map position as the warm-up pose makes the
    # LOCAL-mode move a no-op too — a resumed checkpoint's content and
    # position survive the warm-up untouched.
    pos = np.asarray(state.position, dtype=np.float32)
    warm_pose = eye.copy()
    warm_pose[0, 3], warm_pose[1, 3] = pos[0], pos[1]
    state = seq(
        state,
        jnp.full((K, cap, 3), 1e9, jnp.float32),
        jnp.zeros((K, cap), bool),
        tbs_j,
        jnp.broadcast_to(jnp.asarray(warm_pose), (K, 4, 4)),
    )
    jax.block_until_ready(state.layers)

    t0 = time.time()
    n_total = 0
    with native.ScanStream(
        files, cap, threads=args.prefetch, ring=max(2 * K, 8)
    ) as stream:
        chunk_xyz, chunk_mask, chunk_pose = [], [], []

        def flush():
            nonlocal state
            if not chunk_xyz:
                return
            pad = K - len(chunk_xyz)
            xyz = np.stack(chunk_xyz + [chunk_xyz[-1]] * pad)
            mask = np.stack(
                chunk_mask + [np.zeros(cap, bool)] * pad
            )
            pose = np.stack(chunk_pose + [chunk_pose[-1]] * pad)
            state = seq(
                state, jnp.asarray(xyz), jnp.asarray(mask), tbs_j,
                jnp.asarray(pose),
            )
            chunk_xyz.clear(); chunk_mask.clear(); chunk_pose.clear()

        for i, (xyz, mask, _) in enumerate(stream):
            if not mask.any():
                continue  # parse failure: warn-and-skip (ScanStream logs)
            chunk_xyz.append(xyz)
            chunk_mask.append(mask)
            chunk_pose.append(
                poses[min(i, len(poses) - 1)].astype(np.float32)
                if poses is not None
                else eye
            )
            n_total += 1
            if len(chunk_xyz) == K:
                flush()
        flush()
        errors = stream.errors
    jax.block_until_ready(state.layers)
    mapper.state = state
    dt = time.time() - t0
    print(
        f"[fastdem_replay] {n_total} scans in {dt*1e3:.1f} ms "
        f"({n_total/max(dt,1e-9):.0f} scans/s incl. file IO, "
        f"{dt/max(n_total,1)*1e3:.3f} ms/scan, batch={K}, "
        f"prefetch={args.prefetch} threads, native={native.available()}, "
        f"{errors} parse failures)",
        file=sys.stderr,
    )
    save_artifacts(args, geom, mapper)


if __name__ == "__main__":
    sys.exit(main())
