#!/usr/bin/env python
"""Regenerate the reference C++ baseline on this host.

Builds the reference pipeline via the nanoGrid compatibility layer
(tests/refbuild/ — the same binary the golden tests numerically validate),
feeds it the bench.py headline scan stream, and times the integrate loop
(best of N reps, IO/alloc excluded). BASELINE.md holds the reference's
own published numbers.

Usage: python tools/bench_reference.py [--points 30000] [--scans 16]
       [--raycast 0|1] [--estimator kalman|p2] [--reps 5]
"""

import argparse
import os
import struct
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFBUILD = os.path.join(REPO, "tests", "refbuild")
REF = "/root/reference/fastdem"
TF_INC = "/opt/venv/lib/python3.12/site-packages/tensorflow/include"
SOURCES = [
    "fastdem.cpp", "elevation_mapping.cpp", "sensor_model.cpp",
    "raycasting.cpp", "inpainting.cpp", "uncertainty_fusion.cpp",
    "feature_extraction.cpp", "io_npz.cpp", "pcd_convert.cpp",
    "io_png.cpp",
]


def build(out):
    cmd = [
        "g++", "-O3", "-mavx2", "-mfma", "-DNDEBUG", "-std=c++17",
        "-I", REFBUILD,
        "-I", os.path.join(REF, "include"),
        "-I", os.path.join(REF, "lib", "nanoPCL", "include"),
        "-I", os.path.join(REF, "lib", "nanoPCL", "thirdparty"),
        "-I", os.path.join(REF, "lib", "stb"),
        "-I", TF_INC,
        os.path.join(REFBUILD, "golden_gen.cpp"),
        *[os.path.join(REF, "src", s) for s in SOURCES],
        "-o", out,
    ]
    subprocess.run(cmd, check=True, capture_output=True, timeout=600)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--points", type=int, default=30000)
    ap.add_argument("--scans", type=int, default=16)
    ap.add_argument("--raycast", type=int, default=1)
    ap.add_argument("--estimator", default="kalman", choices=["kalman", "p2"])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    tmp = tempfile.mkdtemp()
    binary = os.path.join(tmp, "golden_bench")
    print("building reference...", file=sys.stderr)
    build(binary)

    # Same stream as bench.py's headline.
    K, N = args.scans, args.points
    rng = np.random.default_rng(0)
    ang = rng.uniform(0, 2 * np.pi, (K, N))
    rad = rng.uniform(0.5, 7.2, (K, N))
    x = rad * np.cos(ang)
    y = rad * np.sin(ang)
    z = 0.2 * np.sin(0.8 * x) * np.cos(0.6 * y) - 1.0 + rng.normal(
        0, 0.02, (K, N)
    )
    xyz = np.stack([x, y, z], -1).astype(np.float32)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, 0, 3] = np.cumsum(rng.normal(0, 0.05, K)).astype(np.float32)
    with open(f"{tmp}/scans.bin", "wb") as f:
        f.write(struct.pack("<ii", K, N))
        f.write(xyz.tobytes())
    with open(f"{tmp}/poses.bin", "wb") as f:
        f.write(T_bs.tobytes())
        f.write(poses.tobytes())

    env = dict(os.environ)
    env["FASTDEM_BENCH_REPS"] = str(args.reps)
    r = subprocess.run(
        [binary, f"{tmp}/scans.bin", f"{tmp}/poses.bin", f"{tmp}/o.npz",
         args.estimator, str(args.raycast), "local", "15", "15", "0.1"],
        capture_output=True, text=True, env=env, timeout=600,
    )
    if r.returncode != 0:
        print(r.stderr[-800:], file=sys.stderr)
        return 1
    for line in r.stdout.splitlines():
        if line.startswith("bench"):
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
