#!/usr/bin/env python
"""Multi-process weak-scaling report (BASELINE config 5).

Weak scaling is the multi-host story: map AREA grows with the process count
while each device keeps a constant-size block, so ideal scaling integrates a
scan into the N-x-larger map in the same wall time and
``efficiency = t_1proc / t_Nproc``.

Parent mode (no --pid) orchestrates the measurement on this machine:
  1. a 1-process run (D virtual CPU devices, map = D blocks)
  2. an N-process jax.distributed run (N x D devices, map = N*D blocks)
and writes the report (--out).

The children run on virtual CPU devices (--force-cpu 1), so the numbers
validate the multi-process RUNTIME and the partitioning's communication
structure, not device throughput — the label is in the report. On GPU
hosts: drop --force-cpu, point --coordinator at host 0, run one child per
GPU with its own CUDA_VISIBLE_DEVICES (parallel/distributed.py).

Usage:
  python tools/multihost_scaling.py --out report.json         # parent
  python tools/multihost_scaling.py --pid 2 --nproc 4         # child
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

BLOCK_ROWS = 160  # per-device block (32 m @ 0.2 m)
BLOCK_COLS = 160


def child(args):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.local_devices}"
    ).strip()
    import jax

    if args.force_cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.nproc > 1:
        jax.distributed.initialize(
            args.coordinator, num_processes=args.nproc, process_id=args.pid
        )

    import jax.numpy as jnp
    import numpy as np

    from fastdem_tpu import Config, GridGeometry, MappingMode
    from fastdem_tpu.mapping.pipeline import create_map_state
    from fastdem_tpu.parallel import sharding as sh

    mesh = sh.make_mesh()
    mx, my = mesh.shape["mx"], mesh.shape["my"]
    geom = GridGeometry(
        rows=BLOCK_ROWS * mx, cols=BLOCK_COLS * my, resolution=0.2
    )
    cfg = Config()
    cfg.mapping.mode = MappingMode.GLOBAL
    cfg.raycasting.enabled = bool(args.raycast)
    # Range sets the update-window size: keep window <= half the SMALLEST
    # leg's map so BOTH legs take the shard_map windowed formulation
    # (zero per-scan collectives) — the baseline 160-col map at 0.2 m
    # admits a <=80-cell window, i.e. range <= 7.5 m with margin.
    cfg.point_filter.range_max = args.range

    step, shard = sh.build_sharded_integrate(geom, cfg, mesh, donate=False)
    state = shard(create_map_state(geom, cfg))

    rng = np.random.default_rng(0)  # identical stream on every process
    n = args.points
    T_bs = jnp.eye(4).at[2, 3].set(0.6)
    scans = []
    for k in range(args.scans):
        ang = rng.uniform(0, 2 * np.pi, n)
        rad = rng.uniform(0.5, args.range - 0.5, n)
        xyz = np.column_stack(
            [rad * np.cos(ang), rad * np.sin(ang), 0.2 * np.sin(rad) - 1.0]
        ).astype(np.float32)
        T_wb = np.eye(4, dtype=np.float32)
        T_wb[0, 3] = 0.4 * k
        scans.append((jnp.asarray(xyz), jnp.asarray(T_wb)))
    mask = jnp.ones(n, dtype=bool)

    # Warmup (compile), then timed per-scan dispatches.
    s = state
    for xyz, T_wb in scans[:2]:
        s, _ = step(s, xyz, mask, T_bs, T_wb)
    jax.block_until_ready(s.layers)
    t0 = time.time()
    s = state
    for _ in range(args.reps):
        for xyz, T_wb in scans:
            s, _ = step(s, xyz, mask, T_bs, T_wb)
    jax.block_until_ready(s.layers)
    ms = (time.time() - t0) / (args.reps * len(scans)) * 1e3

    # Collective audit from the COMPILED programs: the
    # design claims per-scan integrate is collective-free and postprocess
    # moves only halo bytes — verify from the optimized HLO, not prose.
    from fastdem_tpu.config.config import PostProcessConfig
    from fastdem_tpu.postprocess import apply_postprocess_fn
    from fastdem_tpu.utils.hloanalysis import compiled_collective_bytes

    audit = {}
    try:
        x0, tw0 = scans[0]
        audit["integrate_per_scan"] = compiled_collective_bytes(
            step._jitted, state, x0, mask, T_bs, tw0
        )
        audit["integrate_formulation"] = getattr(
            step, "formulation", "unknown"
        )
    except Exception as e:  # noqa: BLE001
        audit["integrate_per_scan"] = {"error": repr(e)}
    try:
        pp = PostProcessConfig()
        pp.inpainting.enabled = True
        pp.uncertainty_fusion.enabled = True
        pp.feature_extraction.enabled = True
        ppfn = jax.jit(apply_postprocess_fn(geom, pp))
        e_l = s.layers["elevation"]
        audit["postprocess_halo_per_pass"] = compiled_collective_bytes(
            ppfn, e_l, e_l, e_l
        )
    except Exception as e:  # noqa: BLE001
        audit["postprocess_halo_per_pass"] = {"error": repr(e)}

    # A cross-process-identical map digest: proves all processes computed
    # the same global map (replicated-scan design), not just "ran".
    import zlib

    if args.nproc > 1:
        from jax.experimental import multihost_utils

        elev_arr = multihost_utils.process_allgather(
            s.layers["elevation"], tiled=True
        )
    else:
        elev_arr = jax.device_get(s.layers["elevation"])
    elev = np.nan_to_num(np.asarray(elev_arr), nan=-1e9)
    digest = zlib.crc32(elev.tobytes())

    if jax.process_index() == 0:
        print(
            "CHILDRESULT "
            + json.dumps(
                {
                    "nproc": jax.process_count(),
                    "devices": jax.device_count(),
                    "mesh": [mx, my],
                    "map_shape": [geom.rows, geom.cols],
                    "points": n,
                    "scans_timed": args.reps * len(scans),
                    "ms_per_scan": round(ms, 3),
                    "elevation_crc32": digest,
                    "raycast": bool(args.raycast),
                    "collective_audit": audit,
                }
            ),
            flush=True,
        )
    else:
        print(f"CHILDCRC pid={args.pid} crc={digest}", flush=True)


def run_group(nproc, args, port):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    host = args.coordinator.rsplit(":", 1)[0]
    procs = []
    for pid in range(nproc):
        cmd = [
            sys.executable, os.path.abspath(__file__),
            "--pid", str(pid), "--nproc", str(nproc),
            "--coordinator", f"{host}:{port}",
            "--local-devices", str(args.local_devices),
            "--points", str(args.points), "--scans", str(args.scans),
            "--reps", str(args.reps), "--raycast", str(args.raycast),
            "--range", str(args.range),
            "--force-cpu", str(args.force_cpu),
        ]
        procs.append(
            subprocess.Popen(
                cmd, env=env, cwd=os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__))),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
        )
    result, crcs = None, []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        if p.returncode != 0:
            raise RuntimeError(f"child failed:\n{out[-3000:]}")
        for line in out.splitlines():
            if line.startswith("CHILDRESULT "):
                result = json.loads(line[len("CHILDRESULT "):])
            elif line.startswith("CHILDCRC "):
                crcs.append(int(line.rsplit("=", 1)[1]))
    if result is None:
        raise RuntimeError("no CHILDRESULT from process 0")
    if any(c != result["elevation_crc32"] for c in crcs):
        raise RuntimeError(f"cross-process map digests differ: "
                           f"{result['elevation_crc32']} vs {crcs}")
    result["all_process_digests_match"] = True
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--coordinator", default="localhost:12461")
    ap.add_argument("--local-devices", type=int, default=2)
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--scans", type=int, default=6)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--raycast", type=int, default=0)
    ap.add_argument("--range", type=float, default=7.0)
    ap.add_argument("--force-cpu", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.pid is not None:
        child(args)
        return

    # Group coordinator ports derive from --coordinator (base and base+1),
    # so a busy default port can be steered around from the parent.
    base_port = int(args.coordinator.rsplit(":", 1)[1])
    r1 = run_group(1, args, base_port)
    rn = run_group(args.nproc, args, base_port + 1)
    eff = r1["ms_per_scan"] / rn["ms_per_scan"]

    report = {
        "kind": "weak_scaling",
        "platform": "virtual CPU devices (validates the jax.distributed "
                    "runtime + partitioning, not device throughput)"
                    if args.force_cpu else "accelerator devices",
        "physical_cores": os.cpu_count(),
        "oversubscription_note": f"{args.nproc} processes x "
                                 f"{args.local_devices} device threads on "
                                 f"{os.cpu_count()} cores — the efficiency "
                                 "number is bounded by host CPU contention, "
                                 "not by the partitioning's communication",
        "per_device_block_cells": [BLOCK_ROWS, BLOCK_COLS],
        "baseline_1proc": r1,
        "scaled": rn,
        "weak_efficiency": round(eff, 3),
    }
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
