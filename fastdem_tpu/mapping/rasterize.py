"""Point-to-cell rasterization — sort-based, scatter-free.

Replaces the reference's per-point hash-map accumulation
(/root/reference/fastdem/src/elevation_mapping.cpp:41-92, the hottest loop
in the pipeline). ``rasterize`` is the sort-based formulation, with no
duplicate-index scatter at all (ops/segments.py):

  1. ONE lexicographic sort of the scan by (valid, cell_id, z, z_var):
     within each cell's run, the head is the min-z point with the smallest
     variance among exact ties (the reference's first-strict-min semantics
     up to tie order) and the tail is the max-z point.
  2. dense [H*W] results come from a vectorized searchsorted over the
     sorted cell ids + gathers at run heads/tails. Counts are right-left.
  3. channel reductions that aren't z-ordered (intensity max) use one
     log-depth segmented scan.

Per-cell observation semantics (CellObservation,
mapping/elevation_mapping.hpp:26-34): min_z, min_z_var, max_z,
max_intensity, color (min-z point's color; reference: last write —
order-free deviation, visualization-only layer).

``rasterize_scatter`` keeps the direct scatter formulation for parity tests
and as a fallback; ``rasterize_stats`` (batch path) stays scatter-based —
the offline path is not latency-critical.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from fastdem_tpu.grid.geometry import GridGeometry
from fastdem_tpu.ops import segments as seg

_INF = jnp.inf


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CellObservations:
    """Dense per-cell observations from one scan. Untouched cells hold NaN
    (min_z/max_z/...) / False (touched)."""

    min_z: jnp.ndarray
    min_z_var: jnp.ndarray
    max_z: jnp.ndarray
    touched: jnp.ndarray
    max_intensity: Optional[jnp.ndarray]
    color: Optional[jnp.ndarray]
    # Number of distinct z-voxels (side = grid resolution) among the cell's
    # points: the raycaster's observed-evidence multiplicity (the reference
    # feeds it the voxel-downsampled scan, src/fastdem.cpp:156-158).
    voxel_count: Optional[jnp.ndarray] = None
    # Fused-scatter rider output (see rasterize_scatter extra_min_scatter).
    extra: Optional[jnp.ndarray] = None


def rasterize(
    geom: GridGeometry,
    position: jnp.ndarray,
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    z_var: jnp.ndarray,
    intensity: Optional[jnp.ndarray] = None,
    color_packed: Optional[jnp.ndarray] = None,
    with_voxel_count: bool = False,
) -> CellObservations:
    """Sort-based rasterization of one scan (see module docstring)."""
    ncell = geom.num_cells
    shape = geom.shape
    n = xyz.shape[0]
    ids, inside = geom.cell_id_of(position, xyz[:, :2])
    valid = mask & inside
    ids = jnp.where(valid, ids, ncell)
    invalid = (~valid).astype(jnp.int32)
    z = xyz[:, 2]

    ops = [invalid, ids, z, z_var]
    n_extra = 0
    if intensity is not None:
        ops.append(intensity)
        n_extra += 1
    if color_packed is not None:
        ops.append(color_packed)
        n_extra += 1
    sorted_ops = jax.lax.sort(tuple(ops), num_keys=4, is_stable=False)
    inv_s, ids_s, z_s, var_s = sorted_ops[:4]
    extras = sorted_ops[4:]
    valid_s = inv_s == 0

    left, right, hit = seg.dense_lookup(ids_s, ncell)
    touched = hit

    min_z = seg.gather_at(z_s, left, hit).reshape(shape)
    min_z_var = seg.gather_at(var_s, left, hit).reshape(shape)
    max_z = seg.gather_at(z_s, right - 1, hit).reshape(shape)

    heads = None
    max_intensity = None
    color = None
    i_extra = 0
    if intensity is not None:
        heads = seg.segment_heads(ids_s, valid_s)
        # Identity-guard invalid tail entries (see segments.segmented_scan).
        int_s = jnp.where(valid_s, extras[i_extra], -_INF)
        i_extra += 1
        # Full-run max available at the head via a reverse (suffix) scan.
        run_max = seg.segmented_scan(jnp.maximum, int_s, heads, reverse=True)
        max_intensity = seg.gather_at(run_max, left, hit).reshape(shape)
    if color_packed is not None:
        col_s = extras[i_extra]
        color = seg.gather_at(col_s, left, hit).reshape(shape)

    voxel_count = None
    if with_voxel_count:
        # Distinct z-voxels per cell: z is sorted within the run, so count
        # z-bin changes. Voxel z-bins use world-origin binning like
        # nanopcl::voxelGrid (core/voxel.hpp:28-43).
        zbin = jnp.floor(z_s / geom.resolution).astype(jnp.int32)
        prev_same_cell = (ids_s == jnp.roll(ids_s, 1)).at[0].set(False)
        new_voxel = valid_s & (
            ~prev_same_cell | (zbin != jnp.roll(zbin, 1))
        )
        csum = jnp.cumsum(new_voxel.astype(jnp.int32))
        # count in run = csum at tail - csum before head
        at_tail = seg.gather_at(
            csum.astype(jnp.float32), right - 1, hit, fill=0.0
        )
        before_head = jnp.where(
            left > 0,
            seg.gather_at(csum.astype(jnp.float32), left - 1, hit, fill=0.0),
            0.0,
        )
        voxel_count = (at_tail - before_head).reshape(shape)

    return CellObservations(
        min_z=min_z,
        min_z_var=min_z_var,
        max_z=max_z,
        touched=touched.reshape(shape),
        max_intensity=max_intensity,
        color=color,
        voxel_count=voxel_count,
    )


def rasterize_scatter(
    geom: GridGeometry,
    position: jnp.ndarray,
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    z_var: jnp.ndarray,
    intensity: Optional[jnp.ndarray] = None,
    color_packed: Optional[jnp.ndarray] = None,
    with_voxel_count: bool = False,
    extra_min_scatter=None,
    phase_gather_rider=None,
) -> CellObservations:
    """Direct scatter formulation.

    Independent reductions are FUSED into single scatter calls over a
    widened table: phase 1 reduces min(z) and
    max(z) (as min(-z)) in one scatter; phase 2 — which needs phase 1's
    minima for the argmin-carried variance/color — reduces variance,
    -intensity, and color in a second single scatter.

    ``extra_min_scatter``: optional (ids, values, table_size) of an
    unrelated min-reduction to ride phase 1 (the pipeline fuses the
    raycaster's polar slope scatter here); its table lands in
    ``CellObservations.extra``.

    ``phase_gather_rider``: optional callable ``extra_table -> (buf, idx)``
    invoked between the phases. The rider's lookups are CONCATENATED with
    the rasterizer's own min-z-per-point gather into a single gather op;
    ``buf[idx]`` lands in
    ``CellObservations.extra`` instead of the raw table.
    """
    ncell = geom.num_cells
    shape = geom.shape
    ids, inside = geom.cell_id_of(position, xyz[:, :2])
    valid = mask & inside
    ids = jnp.where(valid, ids, ncell)
    z = xyz[:, 2]

    # ---- Phase 1: min z and max z in ONE scatter over a [2C] table ----
    stride = ncell + 1
    id1 = [ids, ids + stride]
    v1 = [jnp.where(valid, z, _INF), jnp.where(valid, -z, _INF)]
    t1_len = 2 * stride
    if extra_min_scatter is not None:
        e_ids, e_vals, e_size = extra_min_scatter
        id1.append(e_ids + t1_len)
        v1.append(e_vals)
        t1_len += e_size
    t1 = (
        jnp.full(t1_len, _INF, dtype=jnp.float32)
        .at[jnp.concatenate(id1)]
        .min(jnp.concatenate(v1))
    )
    min_z = t1[:ncell]
    max_z = -t1[stride : stride + ncell]
    extra = t1[2 * stride : t1_len - 1] if extra_min_scatter is not None else None
    touched = jnp.isfinite(min_z)

    gather_idx = jnp.minimum(ids, ncell - 1)
    if phase_gather_rider is not None:
        rider_buf, rider_idx = phase_gather_rider(extra)
        n_pts = gather_idx.shape[0]
        buf = jnp.concatenate([min_z, rider_buf])
        gidx = jnp.concatenate([gather_idx, rider_idx + ncell])
        g = buf[gidx]
        cell_min_at_pt = g[:n_pts]
        extra = g[n_pts:]
    else:
        cell_min_at_pt = min_z[gather_idx]
    at_min = valid & (z == cell_min_at_pt)

    # ---- Phase 2: variance@min, -intensity, color@min fused ----
    lanes = [jnp.where(at_min, z_var, _INF)]
    id_groups = [ids]
    if intensity is not None:
        lanes.append(jnp.where(valid, -intensity, _INF))
        id_groups.append(ids + len(id_groups) * stride)
    if color_packed is not None:
        lanes.append(jnp.where(at_min, color_packed, _INF))
        id_groups.append(ids + len(id_groups) * stride)
    table_len = len(lanes) * stride
    ZB = 32  # z-presence sub-bins per cell for the distinct-voxel count
    # The presence table costs ncell * ZB slots — fine for local maps but
    # O(map area) on large global maps; those use the sort-based count
    # instead (O(N log N), map-size independent).
    vox_in_table = with_voxel_count and ncell * ZB <= (1 << 21)
    if vox_in_table:
        # Distinct-z-voxel presence rides the same fused scatter: mark
        # (cell, zbin mod ZB) slots with 0.0 and count marked slots per
        # cell afterwards (a dense row-sum). Voxels exactly ZB bins apart
        # alias — a rare undercount that only delays log-odds saturation.
        zbin = jnp.floor(z / geom.resolution).astype(jnp.int32)
        vox_ids = table_len + jnp.minimum(ids, ncell - 1) * ZB + (
            zbin % ZB
        )
        vox_ids = jnp.where(valid, vox_ids, table_len + ncell * ZB)
        lanes.append(jnp.zeros_like(z))
        id_groups.append(vox_ids)
        table_len += ncell * ZB + 1
    ids_k = jnp.concatenate(id_groups)
    vals_k = jnp.concatenate(lanes)
    t2 = jnp.full(table_len, _INF, dtype=jnp.float32).at[ids_k].min(vals_k)
    min_z_var = t2[:ncell]
    lane = 1
    max_intensity = None
    if intensity is not None:
        mi = -t2[lane * stride : lane * stride + ncell]
        max_intensity = jnp.where(jnp.isfinite(mi), mi, jnp.nan).reshape(shape)
        lane += 1
    color = None
    if color_packed is not None:
        c = t2[lane * stride : lane * stride + ncell]
        color = jnp.where(jnp.isfinite(c), c, jnp.nan).reshape(shape)
        lane += 1
    voxel_count = None
    if vox_in_table:
        vox_table = t2[lane * stride : lane * stride + ncell * ZB].reshape(
            ncell, ZB
        )
        voxel_count = jnp.sum(vox_table == 0.0, axis=1).astype(
            jnp.float32
        ).reshape(shape)
    elif with_voxel_count:
        from fastdem_tpu.cloud.filters import voxel_unique_mask

        vm = voxel_unique_mask(xyz, valid, geom.resolution)
        voxel_count = (
            jnp.zeros(ncell + 1, dtype=jnp.float32)
            .at[ids]
            .add(vm.astype(jnp.float32))[:ncell]
        ).reshape(shape)

    return CellObservations(
        min_z=jnp.where(touched, min_z, jnp.nan).reshape(shape),
        min_z_var=jnp.where(touched, min_z_var, jnp.nan).reshape(shape),
        max_z=jnp.where(touched, max_z, jnp.nan).reshape(shape),
        touched=touched.reshape(shape),
        max_intensity=max_intensity,
        color=color,
        voxel_count=voxel_count,
        extra=extra,
    )


def _f32_ordered_i32(x: jnp.ndarray) -> jnp.ndarray:
    """Monotone, involutive f32 <-> int32 reinterpretation: a < b (floats,
    no NaN) iff map(a) < map(b) (signed int32). Negative floats flip their
    non-sign bits so two's-complement ordering matches float ordering; the
    same transform decodes (it is its own inverse on the int side)."""
    b = jax.lax.bitcast_convert_type(x, jnp.int32)
    return b ^ ((b >> 31) & jnp.int32(0x7FFFFFFF))


def _i32_ordered_f32(m: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.bitcast_convert_type(
        m ^ ((m >> 31) & jnp.int32(0x7FFFFFFF)), jnp.float32
    )


_IMAX = jnp.int32(0x7FFFFFFF)


def _z_range(z: jnp.ndarray, mask: jnp.ndarray):
    """(min, max) of z over ``mask``: the argmin lane's quantization
    range. Points whose z differ by less than one quantum tie, and ties go
    to the smallest point index, so the range decides which point's
    variance/color a cell carries."""
    return (
        jnp.min(jnp.where(mask, z, _INF)),
        jnp.max(jnp.where(mask, z, -_INF)),
    )


def _gather_bits(buf: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """``buf[idx]`` for a flat 4-byte ``buf``, gathered as int32 bits.

    Exact for every payload (NaN, +-inf, -0.0, packed colors). Under GSPMD
    a partitioned gather zero-fills non-owned rows and SUM-combines the
    partials; f32 summation would flush denormal bit patterns (packed
    colors, bitcast indices) to zero, int32 addition with 0 is exact.
    """
    g = jax.lax.bitcast_convert_type(buf, jnp.int32)[idx]
    return jax.lax.bitcast_convert_type(g, buf.dtype)


def rasterize_scatter_packed(
    geom: GridGeometry,
    position: jnp.ndarray,
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    z_var: jnp.ndarray,
    intensity: Optional[jnp.ndarray] = None,
    color_packed: Optional[jnp.ndarray] = None,
    with_voxel_count: bool = False,
    extra_min_scatter=None,
    phase_gather_rider=None,
    voxel_count_mode: str = "exact",
    window=None,
    quant_mask=None,
) -> CellObservations:
    """Single-scatter rasterization with argmin carry.

    ``rasterize_scatter`` needs TWO scatter phases because the argmin-carried
    channels (variance/color of the min-z point) require phase 1's minima.
    Here ONE int32 scatter-min over a widened table does everything:

      * min-z lane packs ``(quantized z << idx_bits) | point_index`` so the
        table's minimum yields the argmin point directly; variance/color/
        exact-z of that point come from a (fused) gather at the argmin.
      * value-only lanes (max z as -z, intensity as -intensity, the
        raycaster's polar slopes) use a monotone f32<->int32 bit trick
        (``_f32_ordered_i32``) — EXACT, no quantization.
      * the distinct-z-voxel presence sub-table rides along (0 marks).

    vs the two-phase path this moves every reduction onto one int32
    scatter-min and removes the per-point cell-min gather; on maps small relative to the scan
    (ncell <= 2n) the whole second phase collapses into ncell-indexed
    lookups fused into one gather. The only deviation is at quantization
    ties: among
    points whose z differ by less than (scan z-range / 2^(31-idx_bits))
    (~0.15 mm for 32K-point scans over a 10 m band), the smallest point
    INDEX wins the argmin, so min_z/variance/color come from that point
    (reference semantics: first strict min, elevation_mapping.cpp:65-71).
    max_z / intensity / slopes are bit-identical to rasterize_scatter.

    ``voxel_count_mode``: "exact" counts occupied z-voxels via a presence
    sub-table (or sort fallback on large maps); "span" approximates the
    count as the cell's z-extent in voxels (floor(max/res)-floor(min/res)+1,
    capped at 32 like the presence table) — zero scatter cost and map-size
    independent, but overcounts cells whose z distribution has gaps (more
    observed evidence -> ghosts saturate/clear slightly more conservatively).
    """
    if voxel_count_mode not in ("exact", "span"):
        raise ValueError(f"unknown voxel_count_mode: {voxel_count_mode!r}")
    n = xyz.shape[0]
    idx_bits = max(1, (n - 1).bit_length())
    # One fewer level than the field allows: with qmax all-ones, a
    # valid point at index n-1 (n a power of two) holding the scan's
    # max z would pack to exactly _IMAX — the invalid sentinel — and
    # silently mark its cell untouched.
    qmax = (1 << (31 - idx_bits)) - 2  # quantized-z levels
    ids, valid, ncell, shape = _window_ids(geom, position, xyz, mask, window)
    z = xyz[:, 2]

    # Per-scan dynamic z quantization for the argmin pack.
    zlo, zhi = _z_range(z, valid if quant_mask is None else quant_mask)
    zrange = jnp.maximum(zhi - zlo, 1e-6)
    zq = jnp.clip(
        jnp.floor((z - zlo) / zrange * qmax).astype(jnp.int32), 0, qmax
    )
    iota = jnp.arange(n, dtype=jnp.int32)
    packed = jnp.where(valid, (zq << idx_bits) | iota, _IMAX)

    stride = ncell + 1
    id_groups = [ids, ids + stride]
    lanes = [packed, jnp.where(valid, _f32_ordered_i32(-z), _IMAX)]
    if intensity is not None:
        id_groups.append(ids + len(id_groups) * stride)
        lanes.append(jnp.where(valid, _f32_ordered_i32(-intensity), _IMAX))
    table_len = len(lanes) * stride
    extra_off = None
    if extra_min_scatter is not None:
        e_ids, e_vals, e_size = extra_min_scatter
        extra_off = table_len
        id_groups.append(e_ids + table_len)
        lanes.append(_f32_ordered_i32(e_vals))
        table_len += e_size
    ZB = 32
    vox_in_table = (
        with_voxel_count
        and voxel_count_mode == "exact"
        and ncell * ZB <= (1 << 21)
    )
    if vox_in_table:
        zbin = jnp.floor(z / geom.resolution).astype(jnp.int32)
        vox_ids = table_len + jnp.minimum(ids, ncell - 1) * ZB + (zbin % ZB)
        vox_ids = jnp.where(valid, vox_ids, table_len + ncell * ZB)
        id_groups.append(vox_ids)
        lanes.append(jnp.zeros(n, dtype=jnp.int32))
        vox_off = table_len
        table_len += ncell * ZB + 1

    t = (
        jnp.full(table_len, _IMAX, dtype=jnp.int32)
        .at[jnp.concatenate(id_groups)]
        .min(jnp.concatenate(lanes))
    )

    packed_t = t[:ncell]
    touched = packed_t != _IMAX
    # Untouched cells decode the _IMAX sentinel's low bits (2^idx_bits - 1,
    # possibly >= n when n is not a power of two) — clamp; the gathered
    # garbage is masked by ``touched`` below.
    amin = jnp.minimum(
        packed_t & jnp.int32((1 << idx_bits) - 1), jnp.int32(n - 1)
    )
    max_z = -_i32_ordered_f32(t[stride : stride + ncell])
    lane = 2
    max_intensity = None
    if intensity is not None:
        mi = -_i32_ordered_f32(t[lane * stride : lane * stride + ncell])
        max_intensity = jnp.where(
            jnp.isfinite(mi), mi, jnp.nan
        ).reshape(shape)
        lane += 1
    extra_f32 = None
    if extra_min_scatter is not None:
        seg = t[extra_off : extra_off + e_size - 1]
        extra_f32 = jnp.where(seg == _IMAX, _INF, _i32_ordered_f32(seg))

    # ---- Argmin-carried channels (z / variance / color of the min point).
    # Two equivalent realizations, chosen STATICALLY by cost: the
    # cell-indexed gather costs O(ncell) lookups (wins when the map is
    # small relative to the scan), while the per-point form costs one
    # O(n) gather + one O(n) int32 scatter (wins on large maps, where
    # gathering every cell would scale with MAP AREA — a 200 m global map
    # is 4M cells vs a 30K scan).
    if ncell <= 2 * n:
        # Cell path: ncell-indexed gathers of the argmin channels.
        min_z = _gather_bits(z, amin)
        min_z_var = _gather_bits(z_var, amin)
        color = None
        if color_packed is not None:
            color = jnp.where(
                touched, _gather_bits(color_packed, amin), jnp.nan
            ).reshape(shape)
        if phase_gather_rider is not None:
            rider_buf, rider_idx = phase_gather_rider(extra_f32)
            extra = _gather_bits(rider_buf, rider_idx)
        else:
            extra = extra_f32
    else:
        # Per-point path: find each point's win (amin[ids] == index) with
        # an O(n) lookup, then write the winner's channels with ONE O(n)
        # int32 scatter (unique writer per cell; involution-encoded,
        # exact).
        gather_ids = jnp.minimum(ids, ncell - 1)
        amin_at_pt = amin[gather_ids]
        if phase_gather_rider is not None:
            rider_buf, rider_idx = phase_gather_rider(extra_f32)
            extra = _gather_bits(rider_buf, rider_idx)
        else:
            extra = extra_f32
        at_min = valid & (amin_at_pt == iota)

        lanes2 = [
            jnp.where(at_min, _f32_ordered_i32(z), _IMAX),
            jnp.where(at_min, _f32_ordered_i32(z_var), _IMAX),
        ]
        ids2 = [ids, ids + stride]
        if color_packed is not None:
            lanes2.append(jnp.where(at_min, _f32_ordered_i32(color_packed), _IMAX))
            ids2.append(ids + 2 * stride)
        t2 = (
            jnp.full(len(lanes2) * stride, _IMAX, dtype=jnp.int32)
            .at[jnp.concatenate(ids2)]
            .min(jnp.concatenate(lanes2))
        )
        min_z = _i32_ordered_f32(t2[:ncell])
        min_z_var = _i32_ordered_f32(t2[stride : stride + ncell])
        color = None
        if color_packed is not None:
            color = jnp.where(
                touched, _i32_ordered_f32(t2[2 * stride : 2 * stride + ncell]),
                jnp.nan,
            ).reshape(shape)

    voxel_count = None
    if vox_in_table:
        vox_table = t[vox_off : vox_off + ncell * ZB].reshape(ncell, ZB)
        voxel_count = (
            jnp.sum(vox_table == 0, axis=1).astype(jnp.float32).reshape(shape)
        )
    elif with_voxel_count and voxel_count_mode == "span":
        lo = jnp.floor(min_z / geom.resolution)
        hi = jnp.floor(max_z.reshape(-1) / geom.resolution)
        voxel_count = jnp.where(
            touched, jnp.clip(hi - lo + 1.0, 1.0, float(ZB)), 0.0
        ).reshape(shape)
    elif with_voxel_count:
        from fastdem_tpu.cloud.filters import voxel_unique_mask

        vm = voxel_unique_mask(xyz, valid, geom.resolution)
        voxel_count = (
            jnp.zeros(ncell + 1, dtype=jnp.float32)
            .at[ids]
            .add(vm.astype(jnp.float32))[:ncell]
        ).reshape(shape)

    nan = jnp.nan
    return CellObservations(
        min_z=jnp.where(touched, min_z, nan).reshape(shape),
        min_z_var=jnp.where(touched, min_z_var, nan).reshape(shape),
        max_z=jnp.where(touched, max_z, nan).reshape(shape),
        touched=touched.reshape(shape),
        max_intensity=max_intensity,
        color=color,
        voxel_count=voxel_count,
        extra=extra,
    )


def _window_ids(geom, position, xyz, mask, window):
    """Cell ids for scatter tables, optionally rebased into a window.

    ``window`` = (r0, c0, wr, wc) with traced top-left and static extents:
    ids become window-local (``(r - r0) * wc + (c - c0)``) over a
    ``wr * wc`` table — the per-scan update cost then scales with the
    sensor range, not the map area. Points outside the window are masked
    like out-of-map points (the pipeline sizes the window from the point
    filter's range bound + margin, so none exist — pipeline._build_phases).
    Returns (ids, valid, ncell_eff, shape_eff).
    """
    if window is None:
        ids, inside = geom.cell_id_of(position, xyz[:, :2])
        valid = mask & inside
        ncell = geom.num_cells
        return jnp.where(valid, ids, ncell), valid, ncell, geom.shape
    r0, c0, wr, wc = window
    r, c, inside = geom.index_of(position, xyz[:, :2])
    rl = r - r0
    cl = c - c0
    inside = inside & (rl >= 0) & (rl < wr) & (cl >= 0) & (cl < wc)
    valid = mask & inside
    ncell = wr * wc
    ids = jnp.where(valid, rl * wc + cl, ncell)
    return ids, valid, ncell, (wr, wc)


def rasterize_scatter_rows(
    geom: GridGeometry,
    position: jnp.ndarray,
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    z_var: jnp.ndarray,
    intensity: Optional[jnp.ndarray] = None,
    color_packed: Optional[jnp.ndarray] = None,
    with_voxel_count: bool = False,
    extra_min_scatter=None,
    phase_gather_rider=None,
    voxel_count_mode: str = "exact",
    window=None,
    quant_mask=None,
) -> CellObservations:
    """Row-widened single-index scatter rasterization (the default).

    One index per point for every lane: where the packed formulation
    concatenates lanes into a flat table (4n indices), every per-cell
    reduction here becomes ONE lane of a single [n, L]-row scatter-min
    into an int32 [ncell+1, L] table (whether this beats ``packed`` and
    ``sort`` on the GPU is not measured yet):

      lane 0: packed ``(quantized z << idx_bits) | point_index`` — argmin
              carry for variance/color (reference first-strict-min tie
              semantics up to the z quantum, elevation_mapping.cpp:65-71).
      lane 1: ``_f32_ordered_i32(z)`` — EXACT min z (bit-exact vs the
              reference, unlike the round-1 packed path's quantized z).
      lane 2: ordered(-z) — exact max z.
      lane 3 (optional): ordered(-intensity).
      lanes 4..4+31 (voxel_count_mode="exact"): distinct-z-voxel presence
              bitmap — lane k gets 0 iff the point's (zbin mod 32) == k.
              Rides the row for ~free, so "exact" evidence multiplicity
              no longer costs a separate n-index lane (round-1's "span"
              accuracy trade is obsolete on this path).

    The polar slope reduction (``extra_min_scatter``) keys by polar bin,
    not cell, so it stays a separate flat scatter. The argmin gather
    shrinks to
    variance [+ color] only (min z now comes from lane 1), fused with the
    rider's field lookups as before.

    Table size guard: the row table is [ncell+1, L]; for maps where
    ncell * L exceeds ~2^23 entries the bitmap lanes are dropped and the
    voxel count falls back to span / sort (like round 1's presence table).

    ``quant_mask``: the points whose z range sets the argmin lane's z
    quantum (default: the rasterized points). A device of a sharded map
    rasterizes only its block's points but passes the whole window's, so
    sub-quantum z ties resolve as on one device (see
    rasterize_scatter_packed).
    """
    if voxel_count_mode not in ("exact", "span"):
        raise ValueError(f"unknown voxel_count_mode: {voxel_count_mode!r}")
    n = xyz.shape[0]
    idx_bits = max(1, (n - 1).bit_length())
    qmax = (1 << (31 - idx_bits)) - 2  # see rasterize_scatter_packed
    ids, valid, ncell, shape = _window_ids(geom, position, xyz, mask, window)
    z = xyz[:, 2]

    zlo, zhi = _z_range(z, valid if quant_mask is None else quant_mask)
    zrange = jnp.maximum(zhi - zlo, 1e-6)
    zq = jnp.clip(
        jnp.floor((z - zlo) / zrange * qmax).astype(jnp.int32), 0, qmax
    )
    iota = jnp.arange(n, dtype=jnp.int32)

    lanes = [
        jnp.where(valid, (zq << idx_bits) | iota, _IMAX),
        jnp.where(valid, _f32_ordered_i32(z), _IMAX),
        jnp.where(valid, _f32_ordered_i32(-z), _IMAX),
    ]
    if intensity is not None:
        lanes.append(jnp.where(valid, _f32_ordered_i32(-intensity), _IMAX))
    int_lane = len(lanes) - 1 if intensity is not None else None

    ZB = 32
    vox_in_rows = (
        with_voxel_count
        and voxel_count_mode == "exact"
        and (ncell + 1) * (len(lanes) + ZB) <= (1 << 23)
    )
    vox_lane0 = None
    if vox_in_rows:
        vox_lane0 = len(lanes)
        zbin = jnp.floor(z / geom.resolution).astype(jnp.int32) % ZB
        onehot = jnp.where(
            valid[:, None]
            & (zbin[:, None] == jnp.arange(ZB, dtype=jnp.int32)[None, :]),
            jnp.int32(0),
            _IMAX,
        )
        upd = jnp.concatenate(
            [jnp.stack(lanes, axis=1), onehot], axis=1
        )
    else:
        upd = jnp.stack(lanes, axis=1)
    L = upd.shape[1]

    t = (
        jnp.full((ncell + 1, L), _IMAX, dtype=jnp.int32)
        .at[ids]
        .min(upd)
    )[:ncell]

    packed_t = t[:, 0]
    touched = packed_t != _IMAX
    amin = jnp.minimum(
        packed_t & jnp.int32((1 << idx_bits) - 1), jnp.int32(n - 1)
    )
    min_z = _i32_ordered_f32(t[:, 1])
    max_z = -_i32_ordered_f32(t[:, 2])
    max_intensity = None
    if intensity is not None:
        mi = -_i32_ordered_f32(t[:, int_lane])
        max_intensity = jnp.where(
            jnp.isfinite(mi), mi, jnp.nan
        ).reshape(shape)

    extra_f32 = None
    if extra_min_scatter is not None:
        e_ids, e_vals, e_size = extra_min_scatter
        et = (
            jnp.full(e_size, _IMAX, dtype=jnp.int32)
            .at[e_ids]
            .min(_f32_ordered_i32(e_vals))
        )[: e_size - 1]
        extra_f32 = jnp.where(et == _IMAX, _INF, _i32_ordered_f32(et))

    # ---- Argmin-carried channels: variance [+ color] of the min point.
    # One gather per buffer; cell path when the map is small relative to
    # the scan, per-point path otherwise.
    if ncell <= 2 * n:
        min_z_var = _gather_bits(z_var, amin)
        if color_packed is not None:
            color = jnp.where(
                touched, _gather_bits(color_packed, amin), jnp.nan
            ).reshape(shape)
        else:
            color = None
        if phase_gather_rider is not None:
            rider_buf, rider_idx = phase_gather_rider(extra_f32)
            extra = _gather_bits(rider_buf, rider_idx)
        else:
            extra = extra_f32
    else:
        gather_ids = jnp.minimum(ids, ncell - 1)
        amin_at_pt = amin[gather_ids]
        if phase_gather_rider is not None:
            rider_buf, rider_idx = phase_gather_rider(extra_f32)
            extra = _gather_bits(rider_buf, rider_idx)
        else:
            extra = extra_f32
        at_min = valid & (amin_at_pt == iota)
        lanes2 = [jnp.where(at_min, _f32_ordered_i32(z_var), _IMAX)]
        if color_packed is not None:
            lanes2.append(
                jnp.where(at_min, _f32_ordered_i32(color_packed), _IMAX)
            )
        t2 = (
            jnp.full((ncell + 1, len(lanes2)), _IMAX, dtype=jnp.int32)
            .at[ids]
            .min(jnp.stack(lanes2, axis=1))
        )[:ncell]
        min_z_var = _i32_ordered_f32(t2[:, 0])
        color = None
        if color_packed is not None:
            color = jnp.where(
                touched, _i32_ordered_f32(t2[:, 1]), jnp.nan
            ).reshape(shape)

    voxel_count = None
    if vox_in_rows:
        voxel_count = (
            jnp.sum(t[:, vox_lane0 : vox_lane0 + ZB] == 0, axis=1)
            .astype(jnp.float32)
            .reshape(shape)
        )
    elif with_voxel_count and voxel_count_mode == "span":
        lo = jnp.floor(min_z / geom.resolution)
        hi = jnp.floor(max_z / geom.resolution)
        voxel_count = jnp.where(
            touched, jnp.clip(hi - lo + 1.0, 1.0, 32.0), 0.0
        ).reshape(shape)
    elif with_voxel_count:
        from fastdem_tpu.cloud.filters import voxel_unique_mask

        vm = voxel_unique_mask(xyz, valid, geom.resolution)
        voxel_count = (
            jnp.zeros(ncell + 1, dtype=jnp.float32)
            .at[ids]
            .add(vm.astype(jnp.float32))[:ncell]
        ).reshape(shape)

    nan = jnp.nan
    return CellObservations(
        min_z=jnp.where(touched, min_z, nan).reshape(shape),
        min_z_var=jnp.where(touched, min_z_var, nan).reshape(shape),
        max_z=jnp.where(touched, max_z, nan).reshape(shape),
        touched=touched.reshape(shape),
        max_intensity=max_intensity,
        color=color,
        voxel_count=voxel_count,
        extra=extra,
    )


def rasterize_scatter_rows_batched(
    geom: GridGeometry,
    positions: jnp.ndarray,
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    z_var: jnp.ndarray,
    intensity: Optional[jnp.ndarray] = None,
    color_packed: Optional[jnp.ndarray] = None,
    with_voxel_count: bool = False,
    extra_min_scatter=None,
    phase_gather_rider=None,
    voxel_count_mode: str = "exact",
) -> CellObservations:
    """K-scan microbatched row rasterization (flat offset-index ops).

    Same per-scan semantics as ``rasterize_scatter_rows``, but the K scans'
    irregular ops are each ONE flat op with indices offset by k*stride
    instead of K separate ops (its speed on the GPU is not measured).
    Phase A of the pipeline is per-scan independent given the pose stream
    (pipeline._build_phases), which is what makes this legal: each scan's
    lanes land in its own [ncell+1, L] table slice, so results are
    identical to K sequential calls (vmapped dense prep may reassociate
    FMAs — same caveat as build_integrate_sequence's ray-layer note).

    Inputs carry a leading K dim (positions [K,2], xyz [K,N,3], ...).
    ``extra_min_scatter``: (ids [K,N], vals [K,N], size) — scattered into a
    [K*size] table. ``phase_gather_rider``: callable
    ``extra [K, size-1] -> (buf [K, M], idx [K, nidx])``; the lookups are
    offset-flattened into one gather. Returns CellObservations with [K,...]
    fields (extra: [K, nidx]).
    """
    if voxel_count_mode not in ("exact", "span"):
        raise ValueError(f"unknown voxel_count_mode: {voxel_count_mode!r}")
    ncell = geom.num_cells
    shape = geom.shape
    K, n = xyz.shape[0], xyz.shape[1]
    idx_bits = max(1, (n - 1).bit_length())
    qmax = (1 << (31 - idx_bits)) - 2  # see rasterize_scatter_packed
    ids, inside = jax.vmap(geom.cell_id_of)(positions, xyz[:, :, :2])
    valid = mask & inside
    ids = jnp.where(valid, ids, ncell)
    z = xyz[:, :, 2]

    zlo = jnp.min(jnp.where(valid, z, _INF), axis=1, keepdims=True)
    zhi = jnp.max(jnp.where(valid, z, -_INF), axis=1, keepdims=True)
    zrange = jnp.maximum(zhi - zlo, 1e-6)
    zq = jnp.clip(
        jnp.floor((z - zlo) / zrange * qmax).astype(jnp.int32), 0, qmax
    )
    iota = jnp.arange(n, dtype=jnp.int32)[None, :]

    lanes = [
        jnp.where(valid, (zq << idx_bits) | iota, _IMAX),
        jnp.where(valid, _f32_ordered_i32(z), _IMAX),
        jnp.where(valid, _f32_ordered_i32(-z), _IMAX),
    ]
    if intensity is not None:
        lanes.append(jnp.where(valid, _f32_ordered_i32(-intensity), _IMAX))
    int_lane = len(lanes) - 1 if intensity is not None else None

    ZB = 32
    # K-scaled guard: the batched table is K*(ncell+1) rows (each padded
    # to 128 physical lanes), so the single-scan cap must shrink by K.
    vox_in_rows = (
        with_voxel_count
        and voxel_count_mode == "exact"
        and K * (ncell + 1) * (len(lanes) + ZB) <= (1 << 23)
    )
    vox_lane0 = None
    if vox_in_rows:
        vox_lane0 = len(lanes)
        zbin = jnp.floor(z / geom.resolution).astype(jnp.int32) % ZB
        onehot = jnp.where(
            valid[:, :, None]
            & (zbin[:, :, None] == jnp.arange(ZB, dtype=jnp.int32)),
            jnp.int32(0),
            _IMAX,
        )
        upd = jnp.concatenate([jnp.stack(lanes, axis=2), onehot], axis=2)
    else:
        upd = jnp.stack(lanes, axis=2)
    L = upd.shape[2]

    stride = ncell + 1
    koff = (jnp.arange(K, dtype=jnp.int32) * stride)[:, None]
    t = (
        jnp.full((K * stride, L), _IMAX, dtype=jnp.int32)
        .at[(ids + koff).reshape(-1)]
        .min(upd.reshape(-1, L))
    ).reshape(K, stride, L)[:, :ncell]

    packed_t = t[:, :, 0]
    touched = packed_t != _IMAX
    amin = jnp.minimum(
        packed_t & jnp.int32((1 << idx_bits) - 1), jnp.int32(n - 1)
    )
    min_z = _i32_ordered_f32(t[:, :, 1])
    max_z = -_i32_ordered_f32(t[:, :, 2])
    max_intensity = None
    if intensity is not None:
        mi = -_i32_ordered_f32(t[:, :, int_lane])
        max_intensity = jnp.where(jnp.isfinite(mi), mi, jnp.nan).reshape(
            (K,) + shape
        )

    extra_f32 = None
    if extra_min_scatter is not None:
        e_ids, e_vals, e_size = extra_min_scatter
        ekoff = (jnp.arange(K, dtype=jnp.int32) * e_size)[:, None]
        et = (
            jnp.full(K * e_size, _IMAX, dtype=jnp.int32)
            .at[(e_ids + ekoff).reshape(-1)]
            .min(_f32_ordered_i32(e_vals).reshape(-1))
        ).reshape(K, e_size)[:, : e_size - 1]
        extra_f32 = jnp.where(et == _IMAX, _INF, _i32_ordered_f32(et))

    _i32 = lambda v: jax.lax.bitcast_convert_type(v, jnp.int32)  # noqa: E731
    _f32 = lambda v: jax.lax.bitcast_convert_type(v, jnp.float32)  # noqa: E731
    nkoff = (jnp.arange(K, dtype=jnp.int32) * n)[:, None]
    if ncell <= 2 * n:
        if color_packed is not None:
            rowbuf = jnp.stack(
                [_i32(z_var), _i32(color_packed)], axis=2
            ).reshape(K * n, 2)
            g2 = rowbuf[(amin + nkoff).reshape(-1)].reshape(K, ncell, 2)
            min_z_var = _f32(g2[:, :, 0])
            color = jnp.where(touched, _f32(g2[:, :, 1]), jnp.nan).reshape(
                (K,) + shape
            )
        else:
            min_z_var = _f32(
                _i32(z_var).reshape(-1)[(amin + nkoff).reshape(-1)]
            ).reshape(K, ncell)
            color = None
        if phase_gather_rider is not None:
            rider_buf, rider_idx = phase_gather_rider(extra_f32)
            M = rider_buf.shape[1]
            rkoff = (jnp.arange(K, dtype=jnp.int32) * M)[:, None]
            extra = _f32(
                _i32(rider_buf).reshape(-1)[(rider_idx + rkoff).reshape(-1)]
            ).reshape(K, -1)
        else:
            extra = extra_f32
    else:
        gather_ids = jnp.minimum(ids, ncell - 1)
        amin_flat = amin.reshape(-1)
        ckoff = (jnp.arange(K, dtype=jnp.int32) * ncell)[:, None]
        amin_at_pt = amin_flat[(gather_ids + ckoff).reshape(-1)].reshape(K, n)
        if phase_gather_rider is not None:
            rider_buf, rider_idx = phase_gather_rider(extra_f32)
            M = rider_buf.shape[1]
            rkoff = (jnp.arange(K, dtype=jnp.int32) * M)[:, None]
            extra = _f32(
                _i32(rider_buf).reshape(-1)[(rider_idx + rkoff).reshape(-1)]
            ).reshape(K, -1)
        else:
            extra = extra_f32
        at_min = valid & (amin_at_pt == iota)
        lanes2 = [jnp.where(at_min, _f32_ordered_i32(z_var), _IMAX)]
        if color_packed is not None:
            lanes2.append(
                jnp.where(at_min, _f32_ordered_i32(color_packed), _IMAX)
            )
        t2 = (
            jnp.full((K * stride, len(lanes2)), _IMAX, dtype=jnp.int32)
            .at[(ids + koff).reshape(-1)]
            .min(jnp.stack(lanes2, axis=2).reshape(-1, len(lanes2)))
        ).reshape(K, stride, len(lanes2))[:, :ncell]
        min_z_var = _i32_ordered_f32(t2[:, :, 0])
        color = None
        if color_packed is not None:
            color = jnp.where(
                touched, _i32_ordered_f32(t2[:, :, 1]), jnp.nan
            ).reshape((K,) + shape)

    voxel_count = None
    if vox_in_rows:
        voxel_count = (
            jnp.sum(t[:, :, vox_lane0 : vox_lane0 + ZB] == 0, axis=2)
            .astype(jnp.float32)
            .reshape((K,) + shape)
        )
    elif with_voxel_count and voxel_count_mode == "span":
        lo = jnp.floor(min_z / geom.resolution)
        hi = jnp.floor(max_z / geom.resolution)
        voxel_count = jnp.where(
            touched, jnp.clip(hi - lo + 1.0, 1.0, 32.0), 0.0
        ).reshape((K,) + shape)
    elif with_voxel_count:
        from fastdem_tpu.cloud.filters import voxel_unique_mask

        vm = jax.vmap(voxel_unique_mask, in_axes=(0, 0, None))(
            xyz, valid, geom.resolution
        )
        voxel_count = (
            jnp.zeros(K * stride, dtype=jnp.float32)
            .at[(ids + koff).reshape(-1)]
            .add(vm.astype(jnp.float32).reshape(-1))
        ).reshape(K, stride)[:, :ncell].reshape((K,) + shape)

    nan = jnp.nan
    return CellObservations(
        min_z=jnp.where(touched, min_z, nan).reshape((K,) + shape),
        min_z_var=jnp.where(touched, min_z_var, nan).reshape((K,) + shape),
        max_z=jnp.where(touched, max_z, nan).reshape((K,) + shape),
        touched=touched.reshape((K,) + shape),
        max_intensity=max_intensity,
        color=color,
        voxel_count=voxel_count,
        extra=extra,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CellStats:
    """Batch per-cell statistics (offline DEM path; reference BatchCellStats,
    src/pcd_convert.cpp:32-59)."""

    mean: jnp.ndarray
    variance: jnp.ndarray
    min_z: jnp.ndarray
    max_z: jnp.ndarray
    count: jnp.ndarray
    touched: jnp.ndarray
    max_intensity: Optional[jnp.ndarray]
    color: Optional[jnp.ndarray]


def rasterize_stats(
    geom: GridGeometry,
    position: jnp.ndarray,
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    intensity: Optional[jnp.ndarray] = None,
    color_packed: Optional[jnp.ndarray] = None,
) -> CellStats:
    """Per-cell count/mean/sample-variance/min/max in one scatter pass.

    The reference accumulates Welford-style per point
    (pcd_convert.cpp:44-53); here sums around a per-cell pivot (the cell
    min) for stability: var = (sum_sq - sum^2/n) / (n - 1).
    """
    ncell = geom.num_cells
    shape = geom.shape
    ids, inside = geom.cell_id_of(position, xyz[:, :2])
    valid = mask & inside
    ids = jnp.where(valid, ids, ncell)

    z = xyz[:, 2]
    zmin = (
        jnp.full(ncell + 1, _INF, dtype=jnp.float32)
        .at[ids]
        .min(jnp.where(valid, z, _INF))[:ncell]
    )
    zmax = (
        jnp.full(ncell + 1, -_INF, dtype=jnp.float32)
        .at[ids]
        .max(jnp.where(valid, z, -_INF))[:ncell]
    )
    cnt = (
        jnp.zeros(ncell + 1, dtype=jnp.float32)
        .at[ids]
        .add(valid.astype(jnp.float32))[:ncell]
    )
    touched = cnt > 0

    pivot = jnp.where(touched, zmin, 0.0)
    dz = jnp.where(valid, z - pivot[jnp.minimum(ids, ncell - 1)], 0.0)
    s1 = jnp.zeros(ncell + 1, dtype=jnp.float32).at[ids].add(dz)[:ncell]
    s2 = jnp.zeros(ncell + 1, dtype=jnp.float32).at[ids].add(dz * dz)[:ncell]
    mean = pivot + s1 / jnp.maximum(cnt, 1.0)
    var = jnp.where(
        cnt >= 2.0,
        jnp.maximum(s2 - s1 * s1 / jnp.maximum(cnt, 1.0), 0.0)
        / jnp.maximum(cnt - 1.0, 1.0),
        0.0,
    )

    max_intensity = None
    if intensity is not None:
        mi = (
            jnp.full(ncell + 1, -_INF, dtype=jnp.float32)
            .at[ids]
            .max(jnp.where(valid, intensity, -_INF))[:ncell]
        )
        max_intensity = jnp.where(jnp.isfinite(mi), mi, jnp.nan).reshape(shape)

    color = None
    if color_packed is not None:
        at_min = valid & (z == zmin[jnp.minimum(ids, ncell - 1)])
        c = (
            jnp.full(ncell + 1, _INF, dtype=jnp.float32)
            .at[ids]
            .min(jnp.where(at_min, color_packed, _INF))[:ncell]
        )
        color = jnp.where(jnp.isfinite(c), c, jnp.nan).reshape(shape)

    nan = jnp.nan
    return CellStats(
        mean=jnp.where(touched, mean, nan).reshape(shape),
        variance=jnp.where(touched, var, nan).reshape(shape),
        min_z=jnp.where(touched, zmin, nan).reshape(shape),
        max_z=jnp.where(touched, zmax, nan).reshape(shape),
        count=cnt.reshape(shape),
        touched=touched.reshape(shape),
        max_intensity=max_intensity,
        color=color,
    )
