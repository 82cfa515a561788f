"""Multi-chip map sharding: 2D block-partitioned global maps over a mesh.

The reference is single-threaded on one CPU (SURVEY.md section 2.5); this
module is the new first-class distributed layer required by BASELINE.json:
a fixed-origin global map whose [H, W] layers are block-sharded over a 2D
device mesh ("mx" x "my"), updated with the same integrate pipeline under
``jax.jit`` + ``NamedSharding``. GSPMD partitions the scatter updates and
inserts halo exchanges for the stencil post-processing ops automatically;
per-scan point arrays are replicated (cheap: ~30K points vs multi-GB maps)
so scatters into each block need no cross-device reshuffle of points.

Scaling model: pick the mesh, annotate the shardings, let XLA insert
collectives. GPUs of one host are joined all to all (NVLink), so the mesh
shape follows the map alone: the most-square block grid keeps halos short.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fastdem_tpu.grid.gridmap import GridMapState

MAP_AXES = ("mx", "my")


def make_mesh(
    n_devices: Optional[int] = None, shape: Optional[Tuple[int, int]] = None
) -> Mesh:
    """Build a 2D map mesh. ``shape`` defaults to the most-square factoring
    of the device count (e.g. 8 -> 4x2) so block halos are short on both
    axes."""
    devices = jax.devices()
    n = n_devices or len(devices)
    devices = devices[:n]
    if shape is None:
        a = int(math.sqrt(n))
        while n % a != 0:
            a -= 1
        shape = (n // a, a)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, MAP_AXES)


def map_sharding(mesh: Mesh) -> NamedSharding:
    """Layer sharding: rows over 'mx', cols over 'my'."""
    return NamedSharding(mesh, P(*MAP_AXES))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def state_shardings(mesh: Mesh, state: GridMapState) -> GridMapState:
    """A GridMapState-shaped pytree of shardings (for jit in/out_shardings)."""
    lyr = map_sharding(mesh)
    rep = replicated(mesh)
    return GridMapState(
        layers={k: lyr for k in state.layers}, position=rep
    )


def shard_state(state: GridMapState, mesh: Mesh) -> GridMapState:
    """Place an existing state onto the mesh with block sharding.

    Multi-process meshes cannot ``device_put`` remote shards from one
    process; there each process materializes its addressable shards from
    the (identical) host values via make_array_from_callback.
    """
    sh = state_shardings(mesh, state)
    if jax.process_count() == 1:
        return GridMapState(
            layers={
                k: jax.device_put(v, sh.layers[k])
                for k, v in state.layers.items()
            },
            position=jax.device_put(state.position, sh.position),
        )

    def place(value, sharding):
        host = np.asarray(value)
        return jax.make_array_from_callback(
            host.shape, sharding, lambda idx: host[idx]
        )

    return GridMapState(
        layers={
            k: place(v, sh.layers[k]) for k, v in state.layers.items()
        },
        position=place(state.position, sh.position),
    )


def _shardmap_step(
    geom, cfg, mesh, has_intensity, has_color, donate, window_update,
):
    """shard_map formulation: the whole windowed integrate
    step runs per-device on the block-local layers — each device updates
    the statically clamped intersection of the global update window with
    its block, and the per-scan polar ray field is computed per-device
    from the replicated points. ZERO collectives per scan: blocks tile the global windowed update exactly
    (mapping/pipeline.py spmd_blocks notes).

    Raises ValueError when the configuration can't use it (LOCAL mode,
    no finite range filter, window > half map, indivisible shapes) —
    callers fall back to the GSPMD full-map path.
    """
    # jax >= 0.8 public API renamed check_rep -> check_vma; keep one call
    # convention here and adapt by feature-detecting the kwarg (a jax that
    # exposes jax.shard_map but still takes check_rep would otherwise
    # TypeError instead of falling back).
    try:
        import inspect

        from jax import shard_map as _shard_map

        _kwarg = (
            "check_vma"
            if "check_vma" in inspect.signature(_shard_map).parameters
            else "check_rep"
        )

        def shard_map(*a, check_rep=True, **kw):
            kw[_kwarg] = check_rep
            return _shard_map(*a, **kw)

    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    from fastdem_tpu.mapping.pipeline import (
        IntegrateAux,
        build_integrate,
        create_map_state,
    )

    if window_update is False:
        raise ValueError("caller pinned window_update=False")
    smx, smy = mesh.shape[MAP_AXES[0]], mesh.shape[MAP_AXES[1]]
    raw = build_integrate(
        geom, cfg, has_intensity, has_color, jit=False,
        window_update=window_update, spmd_blocks=(smx, smy),
    )
    proto = create_map_state(geom, cfg, (0.0, 0.0), has_intensity, has_color)
    lyr_spec = P(*MAP_AXES)
    rp = P()
    st_spec = GridMapState(
        layers={k: lyr_spec for k in proto.layers}, position=rp
    )
    aux_spec = IntegrateAux(
        world_xyz=rp, world_mask=rp, z_var=rp, obs=None, oow_points=rp
    )
    n_chan = int(has_intensity) + int(has_color)

    def fixed(state, xyz, mask, T_bs, T_wb, *chans):
        intensity = chans[0] if has_intensity else None
        color = chans[-1] if has_color else None
        return raw(state, xyz, mask, T_bs, T_wb, intensity, color)

    inner = shard_map(
        fixed,
        mesh=mesh,
        in_specs=(st_spec,) + (rp,) * (4 + n_chan),
        out_specs=(st_spec, aux_spec),
        # Replication of the aux outputs holds by construction (they are
        # computed from replicated inputs only); the checker can't see
        # through the scatter/gather ops.
        check_rep=False,
    )
    jitted = jax.jit(inner, donate_argnums=(0,) if donate else ())

    def step(state, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None):
        args = [state, xyz, mask, T_bs, T_wb]
        if has_intensity:
            args.append(intensity)
        if has_color:
            args.append(color_packed)
        return jitted(*args)

    step._jitted = jitted  # AOT/introspection handle (collective audits)
    step.formulation = "shardmap_windowed"
    return step, inner


def build_sharded_integrate(
    geom,
    cfg,
    mesh: Mesh,
    has_intensity: bool = False,
    has_color: bool = False,
    donate: bool = True,
    window_update: bool = None,
):
    """Jit the integrate step over the mesh. Two formulations:

    1. shard_map windowed (GLOBAL maps with a finite range filter): each
       device updates window-intersect-block locally — zero per-scan
       collectives and window-local O(range^2) dense cost. Preferred
       whenever it applies.
    2. GSPMD full-map fallback (LOCAL mode, no usable window, or
       ``window_update=False``): map blocks sharded over the mesh, scan
       arrays replicated, GSPMD partitions the scatters; the update window
       stays off (its slices would insert per-scan collectives).

    Returns (step_fn, shard_fn)."""
    from fastdem_tpu.mapping.pipeline import build_integrate, create_map_state

    try:
        step, _ = _shardmap_step(
            geom, cfg, mesh, has_intensity, has_color, donate,
            window_update,
        )
        return step, lambda s: shard_state(s, mesh)
    except ValueError:
        pass

    raw = build_integrate(
        geom, cfg, has_intensity, has_color, jit=False,
        window_update=False,
    )
    proto = create_map_state(geom, cfg, (0.0, 0.0), has_intensity, has_color)
    st_sh = state_shardings(mesh, proto)
    rep = replicated(mesh)

    # jit in_shardings must match the argument pytree, so the jitted
    # signature carries exactly the configured channel slots; the wrapper
    # below restores build_integrate's uniform
    # (..., intensity=None, color_packed=None) interface.
    n_chan = int(has_intensity) + int(has_color)

    def fixed(state, xyz, mask, T_bs, T_wb, *chans):
        intensity = chans[0] if has_intensity else None
        color = chans[-1] if has_color else None
        return raw(state, xyz, mask, T_bs, T_wb, intensity, color)

    # out_shardings pins the carried state to the block sharding: without
    # it GSPMD may resolve LOCAL mode's roll (collective permute) to a
    # replicated output, which then mismatches in_shardings on the next
    # call.
    jitted = jax.jit(
        fixed,
        in_shardings=(st_sh,) + (rep,) * (4 + n_chan),
        out_shardings=(st_sh, None),
        donate_argnums=(0,) if donate else (),
    )

    def step(state, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None):
        args = [state, xyz, mask, T_bs, T_wb]
        if has_intensity:
            args.append(intensity)
        if has_color:
            args.append(color_packed)
        return jitted(*args)

    step._jitted = jitted  # AOT/introspection handle (collective audits)
    step.formulation = "gspmd_fullmap"
    return step, lambda s: shard_state(s, mesh)


def build_sharded_integrate_sequence(
    geom,
    cfg,
    mesh: Mesh,
    has_intensity: bool = False,
    has_color: bool = False,
    donate: bool = True,
    **seq_kwargs,
):
    """Batched replay over a block-sharded map: lax.scan over K replicated
    scans with the carried layers sharded over the mesh — pod-scale offline
    mapping of large global areas (each device keeps only its map blocks in
    HBM; the per-scan scatter partitions like the single-step path).
    Returns (seq_fn, shard_fn) with seq_fn matching
    mapping.pipeline.build_integrate_sequence's signature.
    """
    from fastdem_tpu.mapping.pipeline import (
        build_integrate_sequence,
        create_map_state,
    )

    # shard_map windowed formulation when it applies (see
    # build_sharded_integrate): lax.scan over the per-device windowed
    # step — zero collectives per scan.
    if seq_kwargs.get("window_update") is not False and not any(
        k != "window_update" for k in seq_kwargs
    ):
        try:
            _, inner = _shardmap_step(
                geom, cfg, mesh, has_intensity, has_color, False,
                seq_kwargs.get("window_update"),
            )

            def scan_fn(state, xyz, mask, T_bs, T_wb, intensity=None,
                        color_packed=None):
                def body(s, inp):
                    args = [s, inp[0], inp[1], T_bs, inp[2]]
                    if has_intensity:
                        args.append(inp[3])
                    if has_color:
                        args.append(inp[-1])
                    s, _ = inner(*args)
                    return s, ()

                xs = [xyz, mask, T_wb]
                if has_intensity:
                    xs.append(intensity)
                if has_color:
                    xs.append(color_packed)
                state, _ = jax.lax.scan(body, state, tuple(xs))
                return state

            jitted_seq = jax.jit(
                scan_fn, donate_argnums=(0,) if donate else ()
            )
            return jitted_seq, lambda s: shard_state(s, mesh)
        except ValueError:
            pass

    # Windowed updates dynamic-slice across block shards (collectives per
    # scan) — the GSPMD fallback keeps full-map updates, whose scatters
    # stay shard-local.
    seq_kwargs.setdefault("window_update", False)
    raw = build_integrate_sequence(
        geom, cfg, has_intensity, has_color, jit=False, **seq_kwargs
    )
    proto = create_map_state(geom, cfg, (0.0, 0.0), has_intensity, has_color)
    st_sh = state_shardings(mesh, proto)
    rep = replicated(mesh)
    n_chan = int(has_intensity) + int(has_color)

    def fixed(state, xyz, mask, T_bs, T_wb, *chans):
        intensity = chans[0] if has_intensity else None
        color = chans[-1] if has_color else None
        return raw(state, xyz, mask, T_bs, T_wb, intensity, color)

    jitted = jax.jit(
        fixed,
        in_shardings=(st_sh,) + (rep,) * (4 + n_chan),
        out_shardings=st_sh,
        donate_argnums=(0,) if donate else (),
    )

    def seq(state, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None):
        args = [state, xyz, mask, T_bs, T_wb]
        if has_intensity:
            args.append(intensity)
        if has_color:
            args.append(color_packed)
        return jitted(*args)

    return seq, lambda s: shard_state(s, mesh)
