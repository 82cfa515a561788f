#!/usr/bin/env python
"""fastdem_node: the streaming mapping application (ROS-node equivalent).

Behavioral surface of the reference node executable
(/root/reference/ros2/src/fastdem_ros_node.cpp): loads a single-YAML node
config, streams scans through the mapping driver under its timers
(visualization + snapshot post-processing), and publishes artifacts
(npz checkpoints, PNG renders) instead of ROS topics. Trigger services map
to --run-postprocess etc. at exit.

Scan sources:
  --synthetic N           N synthetic VLP-16-like scans with a wandering pose
  --scans DIR             directory of .pcd / .bin files (sorted), with
  --trajectory FILE       a TUM (t x y z qx qy qz qw) or KITTI (12-float
                          3x4) trajectory supplying T_world_base per scan

Usage:
  python tools/fastdem_node.py --config fastdem_tpu/config/presets/local_mapping.yaml \
      --synthetic 20 --out fastdem_out [--platform cpu]

``main(argv)`` runs the node in the calling process (chip_smoke.py drives
it that way, so one process holds the device).
"""

import argparse
import glob
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def synthetic_scans(n, num_points=30000, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        ang = rng.uniform(0, 2 * np.pi, num_points)
        rad = rng.uniform(0.5, 7.0, num_points)
        x = rad * np.cos(ang)
        y = rad * np.sin(ang)
        wx = x + 0.3 * i
        z = 0.25 * np.sin(0.6 * wx) * np.cos(0.5 * y) - 1.0 + rng.normal(
            0, 0.02, num_points
        )
        T_wb = np.eye(4, dtype=np.float32)
        T_wb[0, 3] = 0.3 * i
        yield np.column_stack([x, y, z]).astype(np.float32), T_wb, (i + 1) * int(1e9)


def file_scans(scan_dir, trajectory):
    from fastdem_tpu.io import pcd as pcd_io

    files = sorted(
        glob.glob(os.path.join(scan_dir, "*.pcd"))
        + glob.glob(os.path.join(scan_dir, "*.bin"))
    )
    if not files:
        raise SystemExit(f"no .pcd/.bin scans in {scan_dir}")
    poses = None
    times = None
    if trajectory:
        times, poses = pcd_io.load_trajectory(trajectory)
    for i, f in enumerate(files):
        cloud = (
            pcd_io.load_kitti_bin(f) if f.endswith(".bin") else pcd_io.load_pcd(f)
        )
        T_wb = (
            poses[min(i, len(poses) - 1)]
            if poses is not None
            else np.eye(4, dtype=np.float32)
        )
        t_ns = int(times[min(i, len(times) - 1)] * 1e9) if times is not None else i
        yield np.asarray(cloud.xyz), T_wb, t_ns


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--scans", default=None)
    ap.add_argument("--trajectory", default=None)
    ap.add_argument("--out", default="fastdem_out")
    ap.add_argument("--sensor-height", type=float, default=1.0)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="throttle scan intake to N Hz (0 = as fast as possible)")
    ap.add_argument("--async-intake", action="store_true",
                    help="enqueue scans and integrate backlogs as batched "
                         "device programs (oldest scans drop under overload)")
    ap.add_argument("--live-port", type=int, default=None,
                    help="serve the live 3D viewer on this port while "
                         "mapping (io/live_viewer.py; 0 = pick a free "
                         "port); browse the printed URL")
    ap.add_argument("--burst", type=int, default=8,
                    help="max scans per batched program with --async-intake")
    ap.add_argument("--program-cache", default=None, metavar="DIR",
                    help="program-cache bundle (runtime/aotcache.py): load "
                         "compiled executables from DIR instead of paying "
                         "first-run XLA compiles; build one with "
                         "tools/aot_warmup.py")
    args = ap.parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    from fastdem_tpu.runtime import aotcache

    if args.program_cache:
        aotcache.enable(args.program_cache)
    else:
        aotcache.enable_compile_cache()

    from fastdem_tpu.cloud import pointcloud as pc
    from fastdem_tpu.grid.gridmap import layers
    from fastdem_tpu.io.npz import save_npz
    from fastdem_tpu.io.png import save_png
    from fastdem_tpu.runtime import bridge
    from fastdem_tpu.runtime.node_config import NodeConfig
    from fastdem_tpu.runtime.providers import StaticCalibration, TransformBuffer

    os.makedirs(args.out, exist_ok=True)
    try:
        cfg = NodeConfig.load(args.config)
    except OSError as e:
        print(
            f"error: cannot read config '{args.config}': {e} "
            "(presets live in fastdem_tpu/config/presets/)",
            file=sys.stderr,
        )
        return 2

    calib = StaticCalibration(cfg.tf.base_frame)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = args.sensor_height
    calib.set_extrinsic("lidar", T_bs)
    odom = TransformBuffer(
        cfg.tf.base_frame, cfg.tf.map_frame,
        max_stale_time=cfg.tf.max_stale_time,
    )

    driver = cfg.make_driver(
        calibration=calib, odometry=odom, artifact_dir=args.out,
        async_intake=args.async_intake, burst_batch=args.burst,
    )

    live = None
    if args.live_port is not None:
        from fastdem_tpu.io.live_viewer import LiveViewer

        live = LiveViewer(port=args.live_port).start()
        driver.sinks["map"] = live.sink(driver.geom)
        print(f"live viewer: {live.url}", file=sys.stderr)

    if args.synthetic:
        source = synthetic_scans(args.synthetic)
    elif args.scans:
        source = file_scans(args.scans, args.trajectory)
    else:
        raise SystemExit("need --synthetic N or --scans DIR")

    n_ok = 0
    t_start = time.time()
    with driver:
        for xyz, T_wb, t_ns in source:
            odom.add_pose(t_ns, T_wb)
            cloud = pc.from_numpy(xyz, frame_id="lidar", timestamp_ns=t_ns)
            if driver.on_scan(cloud):
                n_ok += 1
            if args.rate > 0:
                time.sleep(1.0 / args.rate)
        if args.async_intake:
            # The first batched compile can take a while; a timed-out
            # drain would snapshot a truncated map.
            if not driver.drain(timeout=600.0):
                print(
                    "warning: intake queue did not drain; final artifacts "
                    "miss trailing scans",
                    file=sys.stderr,
                )
            n_ok = driver._scan_count
        # Final snapshot + postprocess (the run_postprocess trigger).
        result = driver.run_postprocess()
        state = driver.mapper.state

    dt = time.time() - t_start
    elev = np.asarray(state.layers[layers.elevation])
    drop = (
        f", {driver.dropped_scans} dropped" if args.async_intake else ""
    )
    print(
        f"integrated {n_ok} scans in {dt:.1f}s "
        f"({n_ok/dt:.1f} scans/s wall incl. host IO{drop}); "
        f"{np.isfinite(elev).sum()}/{elev.size} cells measured"
    )

    save_npz(os.path.join(args.out, "map_final.npz"), driver.geom, state)
    save_png(os.path.join(args.out, "elevation.png"), state, layers.elevation)
    if "slope" in result:
        import jax.numpy as jnp

        from fastdem_tpu.grid.gridmap import GridMapState

        pp_state = GridMapState(
            layers={k: jnp.asarray(v) for k, v in result.items()},
            position=state.position,
        )
        save_png(
            os.path.join(args.out, "slope.png"), pp_state, "slope"
        )
    cloud_arr = bridge.to_structured_cloud(driver.geom, state)
    np.save(os.path.join(args.out, "map_cloud.npy"), cloud_arr)
    print(f"artifacts -> {args.out}: map_final.npz elevation.png map_cloud.npy")
    if live is not None:
        live.publish(driver.geom, state, title="elevation (final)")
        live.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
