"""Multi-host runtime: jax.distributed bootstrap + sharded checkpointing.

The reference is a single process (SURVEY.md sec. 5.8 — its only transport
is ROS pub/sub at the application edge). Here the multi-host story is the
standard JAX recipe: one process per host, ``jax.distributed.initialize``,
a global 2D map mesh spanning all hosts' devices (parallel/sharding.py),
and fully-addressable global arrays. The GPUs of a host are joined by
NVLink, which carries the halo exchanges GSPMD inserts for stencil
post-processing; the network between hosts only carries scan input
broadcast and checkpoint traffic.

On GPUs, a process drives every GPU it sees, and a JAX process reserves
most of each card's memory when it first uses it. For one process per
GPU (several processes on one host), give each its own card with
``CUDA_VISIBLE_DEVICES`` (process ``i`` sees GPU ``i``) before it imports
JAX, or share a card by setting ``XLA_PYTHON_CLIENT_MEM_FRACTION``.
``coordinator`` must be given explicitly (``localhost:<port>`` on one
host): nothing in the environment tells JAX of a cluster.

Usage (one command per host):
  python -m fastdem_tpu.parallel.distributed --coordinator host0:1234 \
      --num-processes 4 --process-id $RANK  # smoke-test entry point

Library use:
  init_distributed(coordinator, num_processes, process_id)
  mesh = make_global_mesh()
  step, shard = build_sharded_integrate(geom, cfg, mesh)
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the multi-process JAX runtime (no-op when single)."""
    import jax

    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_global_mesh(shape: Optional[Tuple[int, int]] = None):
    """2D map mesh over ALL devices across hosts (jax.devices() is global
    after init_distributed)."""
    from fastdem_tpu.parallel.sharding import make_mesh

    return make_mesh(shape=shape)


def save_sharded_npz(
    path: str, geom, state, frame_id: str = "map", col_block: int = 0
) -> bool:
    """Checkpoint a block-sharded global map in the reference npz schema
    WITHOUT ever assembling a full layer on one host.

    The npy payload is Fortran-order (column-major), so a layer streams to
    disk as contiguous column blocks: each block is replicated via one
    jitted dynamic-slice (an allgather of just that block under GSPMD /
    multi-process), process 0 appends its bytes to the open zip member,
    and the block is dropped. Peak host memory = one ``rows x col_block``
    block per step instead of the whole layer.

    ``col_block``: columns per block; 0 picks ~16 MB blocks. The on-disk
    bytes are identical to ``io.npz.save_npz`` (STORE-mode zip, real
    32-bit sizes — the reference's minimal ZIP parser reads it).
    """
    import io as _io
    import json
    import zipfile

    import jax
    import jax.numpy as jnp
    from numpy.lib import format as npfmt

    from fastdem_tpu.io.npz import METADATA_VERSION, zip_member_info

    rows, cols = geom.rows, geom.cols
    if col_block <= 0:
        col_block = max(1, (16 << 20) // max(rows * 4, 1))
    bw = min(col_block, cols)

    first = next(iter(state.layers.values()))
    is_jax = isinstance(first, jax.Array)
    needs_collective_fetch = is_jax and (
        jax.process_count() > 1
        or not getattr(first.sharding, "is_fully_replicated", True)
    )
    if needs_collective_fetch:
        from jax.sharding import NamedSharding, PartitionSpec as P

        rep = NamedSharding(first.sharding.mesh, P())

        @jax.jit
        def _fetch(a, c0):
            blk = jax.lax.dynamic_slice(a, (0, c0), (rows, bw))
            return jax.lax.with_sharding_constraint(blk, rep)
    else:
        _fetch = None

    # Every process runs the fetch collectives; only process 0 writes.
    write = jax.process_index() == 0
    pos = np.asarray(jax.device_get(state.position), dtype=np.float64)
    meta = {
        "version": METADATA_VERSION,
        "resolution": geom.resolution,
        "position": [float(pos[0]), float(pos[1])],
        "frame_id": frame_id,
        "size": [rows, cols],
        "start_index": [0, 0],
    }
    zf = None
    member = None
    ok = False
    try:
        zf = (
            zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=False)
            if write
            else None
        )
        for name in sorted(state.layers):
            arr = state.layers[name]
            member = (
                zf.open(zip_member_info(name + ".npy"), mode="w")
                if write
                else None
            )
            if write:
                npfmt.write_array_header_1_0(
                    member,
                    {
                        "descr": "<f4",
                        "fortran_order": True,
                        "shape": (rows, cols),
                    },
                )
            for c0 in range(0, cols, bw):
                start = min(c0, cols - bw)
                if _fetch is not None:
                    blk = np.asarray(_fetch(arr, jnp.int32(start)))
                else:
                    blk = np.asarray(arr[:, start : start + bw])
                if write:
                    sub = blk[:, c0 - start : c0 - start + min(bw, cols - c0)]
                    member.write(
                        np.asfortranarray(sub.astype(np.float32, copy=False))
                        .tobytes(order="F")
                    )
            if write:
                member.close()
                member = None
        if write:
            buf = _io.BytesIO()
            np.lib.format.write_array(
                buf,
                np.asanyarray(np.bytes_(json.dumps(meta).encode())),
                allow_pickle=False,
            )
            zf.writestr(zip_member_info("meta.npy"), buf.getvalue())
            zf.close()
            zf = None
        ok = True
    except (OSError, zipfile.LargeZipFile):
        # >=4 GiB members would need ZIP64, which the reference's parser
        # cannot read — fail soft like io.npz.save_npz.
        ok = False
    finally:
        # A failed checkpoint must not leak handles or leave a truncated
        # file masquerading as the map.
        for h in (member, zf):
            if h is not None:
                try:
                    h.close()
                except Exception:  # noqa: BLE001
                    pass
        if not ok and write:
            try:
                os.unlink(path)
            except OSError:
                pass
    return ok


def scaling_report(
    geom, cfg, scans: int = 16, points: int = 30000, mode: str = "strong"
) -> dict:
    """Measure scans/s unsharded vs sharded over the local mesh.

    ``mode="strong"``: same map, 1 device vs N — reports
    ``speedup = t_single / t_sharded`` and
    ``efficiency = speedup / N`` (the BASELINE.md metric: >= 80% frames/s
    scaling efficiency at N >= 2 hosts).

    ``mode="weak"``: the realistic pod story — map AREA grows with the
    mesh (rows x mx, cols x my; each device owns a constant-size block).
    Ideal weak scaling integrates a scan into the N-x-larger map in the
    same time, so ``efficiency = t_single / t_sharded`` directly (speedup
    is reported as efficiency * N for symmetry).

    On a single real chip both collapse to sharding-overhead probes; the
    virtual 8-device CPU mesh exercises the partitioning itself.
    """
    if mode not in ("strong", "weak"):
        raise ValueError(f"unknown scaling mode: {mode!r}")
    import time

    import jax
    import jax.numpy as jnp

    from fastdem_tpu.grid.geometry import GridGeometry
    from fastdem_tpu.mapping.pipeline import build_integrate, create_map_state
    from fastdem_tpu.parallel import sharding as sh

    rng = np.random.default_rng(0)
    n = points
    xyz = jnp.asarray(
        np.column_stack(
            [
                rng.uniform(-6, 6, n),
                rng.uniform(-6, 6, n),
                rng.normal(-1.0, 0.05, n),
            ]
        ).astype(np.float32)
    )
    mask = jnp.ones(n, dtype=bool)
    T = jnp.eye(4)

    def time_step(step, state):
        state2, _ = step(state, xyz, mask, T, T)
        jax.block_until_ready(state2.layers)
        t0 = time.time()
        s = state
        for _ in range(scans):
            s, _ = step(s, xyz, mask, T, T)
        jax.block_until_ready(s.layers)
        return (time.time() - t0) / scans

    base_step = build_integrate(geom, cfg, donate=False)
    t_single = time_step(base_step, create_map_state(geom, cfg))

    mesh = sh.make_mesh()
    n_dev = int(np.prod(list(mesh.shape.values())))
    if mode == "weak":
        geom_n = GridGeometry(
            rows=geom.rows * mesh.shape["mx"],
            cols=geom.cols * mesh.shape["my"],
            resolution=geom.resolution,
        )
    else:
        geom_n = geom
    stepN, shard = sh.build_sharded_integrate(geom_n, cfg, mesh, donate=False)
    t_sharded = time_step(stepN, shard(create_map_state(geom_n, cfg)))

    if mode == "weak":
        efficiency = t_single / t_sharded
        speedup = efficiency * n_dev
    else:
        speedup = t_single / t_sharded
        efficiency = speedup / n_dev
    return {
        "devices": n_dev,
        "mode": mode,
        "map_shape_sharded": geom_n.shape,
        "ms_single": t_single * 1e3,
        "ms_sharded": t_sharded * 1e3,
        "speedup": speedup,
        "efficiency": efficiency,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--map-size", type=float, default=50.0)
    ap.add_argument("--resolution", type=float, default=0.1)
    args = ap.parse_args()

    import jax

    init_distributed(args.coordinator, args.num_processes, args.process_id)
    print(
        f"process {jax.process_index()}/{jax.process_count()} "
        f"local={jax.local_device_count()} global={jax.device_count()}"
    )

    from fastdem_tpu.config.config import Config, MappingMode
    from fastdem_tpu.grid.geometry import GridGeometry

    geom = GridGeometry.from_length(args.map_size, args.map_size, args.resolution)
    cfg = Config()
    cfg.mapping.mode = MappingMode.GLOBAL
    rep = scaling_report(geom, cfg)
    print(rep)


if __name__ == "__main__":
    main()
