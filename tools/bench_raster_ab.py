#!/usr/bin/env python
"""Micro A/B: chained rasterize-only cost, twophase vs packed scatter.

Isolates the scatter/gather budget from the rest of the pipeline so the
formulations can be compared with a small, fast-compiling HLO."""
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from fastdem_tpu.grid.geometry import GridGeometry
from fastdem_tpu.mapping import rasterize as R
from fastdem_tpu.postprocess import raycasting as raycast
from fastdem_tpu.runtime.aotcache import enable_compile_cache

GEOM = GridGeometry.from_length(15.0, 15.0, 0.1)
N = 32768
A, RBF = 2048, 0.5
MAXR = 24.0


def make_inputs():
    rng = np.random.default_rng(0)
    ang = rng.uniform(0, 2 * np.pi, N)
    rad = rng.uniform(0.5, 7.2, N)
    xyz = np.stack(
        [rad * np.cos(ang), rad * np.sin(ang),
         0.2 * np.sin(rad) - 1.0 + rng.normal(0, 0.02, N)], -1
    ).astype(np.float32)
    zv = rng.uniform(1e-3, 0.05, N).astype(np.float32)
    return jnp.asarray(xyz), jnp.asarray(zv)


def bench(fn_name, with_ray=True, voxel_count_mode="exact", reps=3, K=32):
    fn = getattr(R, fn_name)
    xyz0, zv = make_inputs()
    mask = jnp.ones(N, bool)
    pos = jnp.zeros(2)
    origin = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    kw = {}
    if fn_name == "rasterize_scatter_packed":
        kw["voxel_count_mode"] = voxel_count_mode

    def one(xyz):
        extra = rider = None
        if with_ray:
            extra = raycast.polar_scatter_spec(
                GEOM, pos, xyz, mask, origin, A, RBF, MAXR)
            a0, a1, r_idx, inr = raycast.resample_indices(
                GEOM, pos, origin, A, RBF, MAXR)
            f0 = (r_idx * A + a0).reshape(-1)
            f1 = (r_idx * A + a1).reshape(-1)

            def rider(tab):
                sm = raycast.polar_smeared_field(GEOM, origin, tab, A, RBF, MAXR)
                return sm.reshape(-1), jnp.concatenate([f0, f1])
        return fn(GEOM, pos, xyz, mask, zv, with_voxel_count=with_ray,
                  extra_min_scatter=extra, phase_gather_rider=rider, **kw)

    @jax.jit
    def chain(xyz):
        def body(c, _):
            obs = one(c)
            # data dependency between iterations (prevents overlap/DCE)
            bump = jnp.nan_to_num(obs.min_z[0, 0]) * 1e-9
            ex = (jnp.nan_to_num(obs.extra[0]) * 1e-12 if obs.extra is not None
                  else 0.0)
            return c + bump + ex, ()
        out, _ = jax.lax.scan(body, xyz, None, length=K)
        return out

    t0 = time.time()
    o = chain(xyz0); jax.block_until_ready(o)
    comp = time.time() - t0
    t0 = time.time()
    for _ in range(reps):
        o = chain(xyz0)
    jax.block_until_ready(o)
    ms = (time.time() - t0) / (reps * K) * 1e3
    tag = fn_name.replace("rasterize_scatter", "") or "twophase"
    print(f"{fn_name[10:] or 'twophase':>10s} ray={int(with_ray)} "
          f"vox={voxel_count_mode}: {ms:6.3f} ms/iter (compile {comp:.0f}s)",
          flush=True)
    return ms


if __name__ == "__main__":
    enable_compile_cache()
    print("device:", jax.devices()[0], flush=True)
    bench("rasterize_scatter_packed")
    bench("rasterize_scatter")
    bench("rasterize_scatter_packed", voxel_count_mode="span")
    bench("rasterize_scatter_packed", with_ray=False)
    bench("rasterize_scatter", with_ray=False)
