#!/usr/bin/env python
"""Raycast envelope vs polar resolution: is there accuracy headroom now
that the dense tail is cheap? Compares _visibility_logodds deviation and
ray-height p99 against the compiled reference DDA for several
(range_bin_factor, num_azimuth) settings.

Measured against the compiled reference (PARITY.md, raycast traversal
row): 4.70%% logodds deviation at the defaults -> 3.88%% at a 4-8x finer
field with ray p99 flat — the residual is the documented all-rays
refinement, not bin starvation.

Run: python tools/bench_envelope.py   (CPU; compiles the C++ reference)
"""
import sys, os, shutil, struct, subprocess, tempfile
import os
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, 'tests'))
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp

import test_reference_goldens as G
from fastdem_tpu import Config, GridGeometry
from fastdem_tpu.mapping.pipeline import build_integrate, create_map_state

tmp = tempfile.mkdtemp(prefix="env_study_")
out = os.path.join(tmp, "golden_gen")
cmd = ["g++", "-O2", "-std=c++17", "-I", G.REFBUILD,
       "-I", os.path.join(G.REF, "include"),
       "-I", os.path.join(G.REF, "lib", "nanoPCL", "include"),
       "-I", os.path.join(G.REF, "lib", "nanoPCL", "thirdparty"),
       "-I", os.path.join(G.REF, "lib", "stb"), "-I", G.TF_INC,
       os.path.join(G.REFBUILD, "golden_gen.cpp"),
       *[os.path.join(G.REF, "src", s) for s in G.REF_SOURCES], "-o", out]
r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
assert r.returncode == 0, r.stderr[-2000:]

from pathlib import Path
xyz, T_bs, poses = G.make_stream()
sref = G.run_reference(out, Path(tmp), xyz, T_bs, poses, "kalman", 1, "local")
ref_lo = np.asarray(sref.layers["_visibility_logodds"])
ref_ray = np.asarray(sref.layers["raycasting"])
ref_ghost = np.asarray(sref.layers["ghost_removal"])

def run_variant(rbf, A):
    cfg = Config(); cfg.raycasting.enabled = True
    geom = GridGeometry.from_length(15.0, 15.0, 0.1)
    step = build_integrate(geom, cfg, donate=False,
                           ray_range_bin_factor=rbf, ray_num_azimuth=A)
    s = create_map_state(geom, cfg)
    for k in range(xyz.shape[0]):
        s, _ = step(s, jnp.asarray(xyz[k]), jnp.asarray(np.ones(xyz.shape[1], bool)),
                    jnp.asarray(T_bs), jnp.asarray(poses[k]))
    lo = np.asarray(s.layers["_visibility_logodds"])
    ray = np.asarray(s.layers["raycasting"])
    ghost = np.asarray(s.layers["ghost_removal"])
    both = np.isfinite(ref_lo) & np.isfinite(lo)
    frac = float((np.abs(ref_lo[both] - lo[both]) > 1e-5).mean())
    br = np.isfinite(ref_ray) & np.isfinite(ray)
    p99 = float(np.percentile(np.abs(ref_ray[br] - ray[br]), 99))
    nanmis = int((np.isnan(ref_ray) != np.isnan(ray)).sum())
    ghost_same = bool(np.array_equal(np.isnan(ref_ghost), np.isnan(ghost)))
    print(f"rbf={rbf:5.3f} A={A}: logodds_dev={frac*100:5.2f}%  ray_p99={p99:.4f} m"
          f"  nan_mis={nanmis}  ghost_exact={ghost_same}", flush=True)

for rbf, A in [(0.25, 2048), (0.125, 2048), (0.25, 4096), (0.125, 4096), (0.0625, 4096)]:
    run_variant(rbf, A)
