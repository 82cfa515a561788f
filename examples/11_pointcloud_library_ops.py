#!/usr/bin/env python
"""The point-cloud-library surface at scale: exact grid kNN, normals,
and dense-correspondence VGICP on a 100K-point scan.

The nanoPCL layer this mirrors (lib/nanoPCL: KdTree search, normal
estimation, VGICP registration) gets its speed from tree traversal on a
CPU; the equivalents here restructure the same queries into dense work
instead:

  * exact kNN: a dense [ncells, m] bucket table — candidate fetch is 27
    CONTIGUOUS slices per cell chunk (zero per-query gathers), with a
    per-query exactness certificate + brute fallback (cloud/search.py;
    bit-identical to brute force);
  * normals/covariances: one batched PCA over the gathered neighborhoods;
  * VGICP: per-voxel Gaussians built densely over a lattice-aligned grid,
    containing-voxel correspondence as arithmetic cell ids, and the whole
    LM solve as ONE device program (cloud/registration.py).

Run: python examples/11_pointcloud_library_ops.py [--platform cpu]
      (defaults to a smaller cloud on CPU so the demo stays snappy)
"""
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    platform = None
    if "--platform" in sys.argv:
        platform = sys.argv[sys.argv.index("--platform") + 1]
    import jax

    if platform:
        jax.config.update("jax_platforms", platform)
    on_cpu = jax.devices()[0].platform == "cpu"
    n = 20_000 if on_cpu else 100_000

    import jax.numpy as jnp

    from fastdem_tpu.cloud import normals, registration, search
    from fastdem_tpu.cloud.pointcloud import from_numpy
    from fastdem_tpu.cloud.transform import from_rpy

    rng = np.random.default_rng(0)
    xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    xyz[:, 2] = (0.1 * np.sin(xyz[:, 0])
                 + 0.02 * rng.normal(size=n)).astype(np.float32)
    cloud = from_numpy(xyz)

    # --- exact kNN through the auto path (grid above 32K points).
    t0 = time.time()
    idx, dist = search.knn(cloud.xyz, cloud.mask, k=10)
    idx.block_until_ready()
    print(f"exact kNN k=10 over {n} pts: {1e3 * (time.time() - t0):.0f} ms "
          f"(mean kth dist {float(jnp.nanmean(dist[:, -1])):.3f} m)")

    # --- normals from the same machinery.
    t0 = time.time()
    withn = normals.estimate_normals(cloud, k=10)
    nz = np.asarray(withn.channels["normal"])[:, 2]
    print(f"normals: {1e3 * (time.time() - t0):.0f} ms "
          f"(median |n_z| {np.median(np.abs(nz)):.3f} — flat-ish terrain)")

    # --- VGICP: recover a known motion.
    T_true = np.asarray(from_rpy(0.02, -0.01, 0.04, t=(0.3, -0.2, 0.1)))
    tgt = ((T_true[:3, :3] @ xyz.T).T + T_true[:3, 3]).astype(np.float32)
    t0 = time.time()
    res = registration.align(
        cloud, from_numpy(tgt), method="vgicp", optimizer="lm",
        voxel_size=1.0, knn_method="grid" if not on_cpu else "brute",
    )
    err = np.linalg.norm(np.asarray(res.T)[:3, 3] - T_true[:3, 3])
    print(f"VGICP {n} pts: {1e3 * (time.time() - t0):.0f} ms, "
          f"converged={res.converged} in {res.iterations} iters, "
          f"t_err={err * 1e3:.1f} mm")
    assert res.converged and err < 0.05
    print("ok")


if __name__ == "__main__":
    main()
