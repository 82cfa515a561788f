"""Sharded map checkpoints via orbax (maps too large to assemble on host).

The npz path (io/npz.py) is the reference-compatible interchange format; it
assembles the global layers on one host. For pod-scale global maps the
orbax path checkpoints the block-sharded arrays directly: each host writes
its own shards, and restore re-shards onto the (possibly different) mesh.

State is stored as {layers: {name: f32[H, W]}, position: f32[2]} plus a
JSON-able metadata dict mirroring the npz schema.
"""

from __future__ import annotations

import os
from typing import Tuple

import jax

from fastdem_tpu.grid.geometry import GridGeometry
from fastdem_tpu.grid.gridmap import GridMapState


def save_orbax(
    path: str,
    geom: GridGeometry,
    state: GridMapState,
    frame_id: str = "map",
) -> None:
    """Write a (possibly sharded) checkpoint directory at ``path``."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(
        os.path.join(path, "state"),
        {"layers": dict(state.layers), "position": state.position},
        force=True,
    )
    ckptr.wait_until_finished()
    if jax.process_index() == 0:
        import json

        meta = {
            "version": 1,
            "resolution": geom.resolution,
            "rows": geom.rows,
            "cols": geom.cols,
            "frame_id": frame_id,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)


def load_orbax(
    path: str, sharding=None
) -> Tuple[GridGeometry, GridMapState, dict]:
    """Restore a checkpoint; optionally straight into ``sharding`` (a
    NamedSharding applied to every layer).

    With ``sharding`` the restore target is an ABSTRACT pytree of
    ``jax.ShapeDtypeStruct``s carrying the shardings (discovered from the
    checkpoint's own structure metadata), so each host reads only its
    shards and no layer is ever materialized whole on one host — the
    point of this path per its module docstring."""
    import json

    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    geom = GridGeometry(
        rows=int(meta["rows"]),
        cols=int(meta["cols"]),
        resolution=float(meta["resolution"]),
    )
    ckptr = ocp.StandardCheckpointer()
    state_dir = os.path.join(path, "state")
    if sharding is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        rep = NamedSharding(sharding.mesh, P())
        # Layer names/shapes/dtypes come from the checkpoint metadata —
        # no array data is read here.
        tree = ckptr.metadata(state_dir).item_metadata.tree
        abstract = {
            "layers": {
                k: jax.ShapeDtypeStruct(v.shape, v.dtype, sharding=sharding)
                for k, v in tree["layers"].items()
            },
            "position": jax.ShapeDtypeStruct(
                tree["position"].shape, tree["position"].dtype, sharding=rep
            ),
        }
        raw = ckptr.restore(state_dir, abstract)
        state = GridMapState(layers=raw["layers"], position=raw["position"])
    else:
        raw = ckptr.restore(state_dir)
        state = GridMapState(layers=raw["layers"], position=raw["position"])
    return geom, state, meta
