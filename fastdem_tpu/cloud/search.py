"""Spatial neighbor search: brute-force, voxel-bucket, and dense-grid kNN.

Data-parallel replacement for nanoPCL's KdTree / VoxelHash
(/root/reference/fastdem/lib/nanoPCL/include/nanopcl/search/kdtree.hpp:20-49,
search/voxel_hash.hpp:22-60). Tree traversal is hostile to SIMD/XLA; instead:

  * brute: doubly-tiled [B, C] distance tiles (query chunks x data chunks)
    with a running top-k merge — EXACT at any N, matmul-shaped (|p-q|^2
    via the Gram-matrix expansion), peak memory independent of N.
  * grid (``knn_grid`` / ``DenseGrid``): EXACT sub-quadratic kNN — a
    host-built dense-CSR voxel grid whose per-query candidates are NINE
    contiguous z-column slices of the spatially sorted cloud (one
    row-slice gather per column), plus a per-query exactness certificate: the
    result is provably exact when no candidate column overflowed its
    capacity AND the kth distance <= bucket_size (a query lies inside its
    own bucket, so every point outside the 3x3x3 neighborhood is > one
    bucket away — the same termination proof as nanoflann's
    ball-within-bounds test). Queries failing the certificate fall back
    to the brute tile — the result is exact at ANY N, with the O(N^2)
    work paid only by the (few) sparse-region queries. The default for
    large concrete clouds.
  * bucket: sort points into voxel buckets (lexicographic sort, CSR ranges
    via searchsorted), gather up to M candidates from each of the 27
    neighboring buckets, top_k over the 27*M candidates — approximate
    (bucket overflow / beyond-adjacent neighbors); kept for latency-bound
    callers that opt in explicitly.

All queries return fixed-shape (indices, distances) with invalid entries
marked by index -1 / distance +inf, so downstream consumers stay jittable.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from fastdem_tpu.cloud.transform import HIGHEST

_INF = jnp.inf

_NEIGHBOR_OFFSETS = [
    (dx, dy, dz)
    for dx in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dz in (-1, 0, 1)
]

# Self-kNN point count above which method="auto" switches from the brute
# tile to the exact grid+certificate path (knn_grid). The brute tile's
# top-k merge cost grows ~N^2; the grid pass is ~linear. (Where the two
# cross on the GPU is not measured.)
_GRID_CROSSOVER = 32768


def _masked_topk_small(d2: jnp.ndarray, k: int):
    """Ascending top-k over a SMALL last axis by k iterative masked-argmin
    passes instead of lax.top_k (a sort): for the candidate widths here (a
    few hundred lanes) k dense min/argmin/mask passes fuse into elementwise
    work. Whether lax.top_k is faster on the GPU is not measured. Ties
    resolve to the smallest lane index
    (argmin convention), matching lax.top_k's stable order.

    Returns (values f32[Q, k] ascending, lane indices i32[Q, k])."""
    q, c = d2.shape
    iota = jax.lax.broadcasted_iota(jnp.int32, (q, c), 1)
    vals, lanes = [], []
    cur = d2
    for _ in range(min(k, c)):
        i = jnp.argmin(cur, axis=1).astype(jnp.int32)
        vals.append(jnp.min(cur, axis=1))
        lanes.append(i)
        cur = jnp.where(iota == i[:, None], _INF, cur)
    v = jnp.stack(vals, axis=1)
    sel = jnp.stack(lanes, axis=1)
    if k > c:
        v = jnp.concatenate(
            [v, jnp.full((q, k - c), _INF, dtype=v.dtype)], axis=1
        )
        sel = jnp.concatenate(
            [sel, jnp.zeros((q, k - c), dtype=jnp.int32)], axis=1
        )
    return v, sel


def knn_brute(
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    k: int,
    queries: Optional[jnp.ndarray] = None,
    exclude_self: bool = True,
    chunk: int = 1024,
    data_chunk: int = 16384,
    self_indices: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact kNN at ANY N by doubly-tiled dense distances with a running
    top-k (the old single-tile form materialized [chunk, N] and the >64K
    path fell back to an approximate bucket search; this form's peak
    memory is [chunk, data_chunk] regardless of N, every point-pair
    distance is a matmul entry, and the per-data-chunk
    merge keeps the best k seen — exact like nanoflann's KdTree queries,
    lib/nanoPCL/include/nanopcl/search/kdtree.hpp:20-49).

    The Gram expansion loses ~1e-3 absolute d2 precision to cancellation
    (coords²-scale rounding), so it only SELECTS candidates: each merge
    keeps the best k + ``pad`` by Gram distance, and a final pass
    recomputes the finalists' distances by exact direct differences and
    re-ranks. A true neighbor is dropped only if more than ``pad``
    spurious candidates beat it within the Gram error band.

    Returns (idx i32[Q, k], dist f32[Q, k]); padding entries idx=-1,
    dist=inf."""
    q = xyz if queries is None else queries
    n = xyz.shape[0]
    pad_k = 8
    ksel = min(k + pad_k, n)

    padn = (-n) % data_chunk
    data = jnp.concatenate([xyz, jnp.full((padn, 3), 1e9, dtype=xyz.dtype)])
    dmask = jnp.concatenate([mask, jnp.zeros(padn, dtype=bool)])
    nd = data.shape[0] // data_chunk
    data_c = data.reshape(nd, data_chunk, 3)
    mask_c = dmask.reshape(nd, data_chunk)
    d2_base = jnp.sum(data_c * data_c, axis=-1)  # [nd, dc]
    bases = jnp.arange(nd, dtype=jnp.int32) * data_chunk
    col_iota = jnp.arange(data_chunk, dtype=jnp.int32)

    def one_chunk(qc):
        qq, self_idx = qc  # [B, 3], [B]
        qn = jnp.sum(qq * qq, axis=1)

        def body(carry, inp):
            best_d, best_i = carry  # [B, ksel]
            pts, msk, base, d2b = inp
            # |q - p|^2 = |q|^2 + |p|^2 - 2 q.p (a matmul; full f32 so
            # the exact-search certificate holds)
            d2 = qn[:, None] + d2b[None, :] - 2.0 * jnp.matmul(
                qq, pts.T, precision=HIGHEST
            )
            d2 = jnp.where(msk[None, :], d2, _INF)
            cols = base + col_iota
            if exclude_self:
                d2 = jnp.where(
                    cols[None, :] == self_idx[:, None], _INF, d2
                )
            cat_d = jnp.concatenate([best_d, d2], axis=1)
            cat_i = jnp.concatenate(
                [best_i, jnp.broadcast_to(cols, d2.shape)], axis=1
            )
            neg, pos = jax.lax.top_k(-cat_d, ksel)
            return (
                (-neg, jnp.take_along_axis(cat_i, pos, axis=1)),
                (),
            )

        B = qq.shape[0]
        init = (
            jnp.full((B, ksel), _INF, dtype=jnp.float32),
            jnp.full((B, ksel), -1, dtype=jnp.int32),
        )
        (bd, bi), _ = jax.lax.scan(
            body, init, (data_c, mask_c, bases, d2_base)
        )
        # Exact refinement: direct-difference distances for the finalists.
        cand = data[jnp.maximum(bi, 0)]  # [B, ksel, 3]
        diff = cand - qq[:, None, :]
        d2x = jnp.sum(diff * diff, axis=-1)
        d2x = jnp.where(jnp.isfinite(bd), d2x, _INF)
        neg, pos = jax.lax.top_k(-d2x, k)
        bd = -neg
        bi = jnp.take_along_axis(bi, pos, axis=1)
        bi = jnp.where(jnp.isfinite(bd), bi, -1)
        return jnp.maximum(bd, 0.0), bi

    nq = q.shape[0]
    pad = (-nq) % chunk
    qp = jnp.concatenate([q, jnp.full((pad, 3), 1e9, dtype=q.dtype)])
    if self_indices is not None:
        self_ids = jnp.concatenate(
            [self_indices.astype(jnp.int32), jnp.full(pad, -1, jnp.int32)]
        )
    elif queries is None:
        self_ids = jnp.concatenate(
            [jnp.arange(nq, dtype=jnp.int32), jnp.full(pad, -1, jnp.int32)]
        )
    else:
        self_ids = jnp.full(nq + pad, -1, jnp.int32)
    qp = qp.reshape(-1, chunk, 3)
    self_ids = self_ids.reshape(-1, chunk)
    d, idx = jax.lax.map(one_chunk, (qp, self_ids))
    d = d.reshape(-1, k)[:nq]
    idx = idx.reshape(-1, k)[:nq]
    return idx, jnp.sqrt(d)


_knn_brute_jit = jax.jit(
    knn_brute,
    static_argnames=("k", "exclude_self", "chunk", "data_chunk"),
)


def radius_count_brute(
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    radius: float,
    queries: Optional[jnp.ndarray] = None,
    exclude_self: bool = True,
    chunk: int = 256,
    data_chunk: int = 8192,
) -> jnp.ndarray:
    """Exact within-radius neighbor counts at any N (doubly-tiled like
    knn_brute; no candidate cap, unlike BucketGrid.radius_count's
    per_bucket truncation). Distances use DIRECT differences — a count
    can't refine a boundary-band candidate after the fact, so the Gram
    form's ~1e-3 cancellation error is not acceptable here; the [B, C, 3]
    tile is elementwise work (offline paths only)."""
    q = xyz if queries is None else queries
    n = xyz.shape[0]
    r2 = radius * radius

    padn = (-n) % data_chunk
    data = jnp.concatenate([xyz, jnp.full((padn, 3), 1e9, dtype=xyz.dtype)])
    dmask = jnp.concatenate([mask, jnp.zeros(padn, dtype=bool)])
    nd = data.shape[0] // data_chunk
    data_c = data.reshape(nd, data_chunk, 3)
    mask_c = dmask.reshape(nd, data_chunk)
    bases = jnp.arange(nd, dtype=jnp.int32) * data_chunk
    col_iota = jnp.arange(data_chunk, dtype=jnp.int32)

    def one_chunk(qc):
        qq, self_idx = qc

        def body(cnt, inp):
            pts, msk, base = inp
            diff = pts[None, :, :] - qq[:, None, :]
            d2 = jnp.sum(diff * diff, axis=-1)
            ok = msk[None, :] & (d2 <= r2)
            if exclude_self:
                cols = base + col_iota
                ok = ok & (cols[None, :] != self_idx[:, None])
            return cnt + jnp.sum(ok, axis=1), ()

        cnt, _ = jax.lax.scan(
            body,
            jnp.zeros(qq.shape[0], dtype=jnp.int32),
            (data_c, mask_c, bases),
        )
        return cnt

    nq = q.shape[0]
    pad = (-nq) % chunk
    qp = jnp.concatenate([q, jnp.full((pad, 3), 1e9, dtype=q.dtype)])
    self_ids = (
        jnp.concatenate(
            [jnp.arange(nq, dtype=jnp.int32), jnp.full(pad, -1, jnp.int32)]
        )
        if queries is None
        else jnp.full(nq + pad, -1, jnp.int32)
    )
    cnt = jax.lax.map(
        one_chunk, (qp.reshape(-1, chunk, 3), self_ids.reshape(-1, chunk))
    )
    return cnt.reshape(-1)[:nq]


def radius_search_brute(
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    radius: float,
    max_neighbors: int,
    queries: Optional[jnp.ndarray] = None,
    exclude_self: bool = True,
    chunk: int = 256,
    data_chunk: int = 8192,
    self_indices: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Exact radius neighbor-SET query at any N.

    The fixed-capacity counterpart of nanoPCL's KdTree::radius, which
    returns the full index set of points within ``radius``
    (lib/nanoPCL/include/nanopcl/search/kdtree.hpp:20-49). Static shapes
    force a capacity: the ``max_neighbors`` CLOSEST in-radius points per
    query are returned, distance-sorted ascending, padded with
    idx=-1/dist=inf. The exact total in-radius count rides the same tiled
    pass for free, so truncation (count > max_neighbors) is detectable by
    the caller.

    Doubly-tiled like knn_brute with a running top-k merge, but distances
    are DIRECT differences (the [B, C, 3] tile is elementwise): a radius
    predicate can't be refined after the fact, so the Gram form's ~1e-3
    cancellation band is not acceptable here (same reasoning as
    radius_count_brute).

    Returns (idx i32[Q, max_neighbors], dist f32[Q, max_neighbors],
    count i32[Q]).
    """
    q = xyz if queries is None else queries
    n = xyz.shape[0]
    r2 = radius * radius
    cap = min(max_neighbors, n)

    padn = (-n) % data_chunk
    data = jnp.concatenate([xyz, jnp.full((padn, 3), 1e9, dtype=xyz.dtype)])
    dmask = jnp.concatenate([mask, jnp.zeros(padn, dtype=bool)])
    nd = data.shape[0] // data_chunk
    data_c = data.reshape(nd, data_chunk, 3)
    mask_c = dmask.reshape(nd, data_chunk)
    bases = jnp.arange(nd, dtype=jnp.int32) * data_chunk
    col_iota = jnp.arange(data_chunk, dtype=jnp.int32)

    def one_chunk(qc):
        qq, self_idx = qc  # [B, 3], [B]
        B = qq.shape[0]

        def body(carry, inp):
            best_d, best_i, cnt = carry
            pts, msk, base = inp
            diff = pts[None, :, :] - qq[:, None, :]
            d2 = jnp.sum(diff * diff, axis=-1)  # exact direct [B, C]
            cols = base + col_iota
            ok = msk[None, :] & (d2 <= r2)
            if exclude_self:
                ok = ok & (cols[None, :] != self_idx[:, None])
            d2 = jnp.where(ok, d2, _INF)
            cnt = cnt + jnp.sum(ok, axis=1)
            cat_d = jnp.concatenate([best_d, d2], axis=1)
            cat_i = jnp.concatenate(
                [best_i, jnp.broadcast_to(cols, d2.shape)], axis=1
            )
            neg, pos = jax.lax.top_k(-cat_d, cap)
            return (
                (-neg, jnp.take_along_axis(cat_i, pos, axis=1), cnt),
                (),
            )

        init = (
            jnp.full((B, cap), _INF, dtype=jnp.float32),
            jnp.full((B, cap), -1, dtype=jnp.int32),
            jnp.zeros(B, dtype=jnp.int32),
        )
        (bd, bi, cnt), _ = jax.lax.scan(
            body, init, (data_c, mask_c, bases)
        )
        bi = jnp.where(jnp.isfinite(bd), bi, -1)
        return bd, bi, cnt

    nq = q.shape[0]
    pad = (-nq) % chunk
    qp = jnp.concatenate([q, jnp.full((pad, 3), 1e9, dtype=q.dtype)])
    if self_indices is not None:
        self_ids = jnp.concatenate(
            [self_indices.astype(jnp.int32), jnp.full(pad, -1, jnp.int32)]
        )
    elif queries is None:
        self_ids = jnp.concatenate(
            [jnp.arange(nq, dtype=jnp.int32), jnp.full(pad, -1, jnp.int32)]
        )
    else:
        self_ids = jnp.full(nq + pad, -1, jnp.int32)
    d, idx, cnt = jax.lax.map(
        one_chunk, (qp.reshape(-1, chunk, 3), self_ids.reshape(-1, chunk))
    )
    d = d.reshape(-1, cap)[:nq]
    idx = idx.reshape(-1, cap)[:nq]
    cnt = cnt.reshape(-1)[:nq]
    if cap < max_neighbors:
        padw = max_neighbors - cap
        d = jnp.concatenate(
            [d, jnp.full((nq, padw), _INF, dtype=d.dtype)], axis=1
        )
        idx = jnp.concatenate(
            [idx, jnp.full((nq, padw), -1, dtype=jnp.int32)], axis=1
        )
    return idx, jnp.sqrt(d), cnt


class BucketGrid:
    """Sorted voxel-bucket index over a fixed cloud (build once, query many).

    The CSR structure is (sorted point order, per-query searchsorted over
    the sorted bucket keys). Bucket keys are linearized into int32 from
    clipped 10-bit coords around the cloud's bounding box.
    """

    def __init__(self, xyz: jnp.ndarray, mask: jnp.ndarray, bucket_size: float):
        self.xyz = xyz
        self.mask = mask
        self.bucket_size = float(bucket_size)
        mins = jnp.min(jnp.where(mask[:, None], xyz, _INF), axis=0)
        self.origin = jnp.where(jnp.isfinite(mins), mins, 0.0) - bucket_size
        coords = self._coords(xyz)
        key = self._key(coords)
        key = jnp.where(mask, key, jnp.int32(2**31 - 1))
        self.sorted_key, self.order = jax.lax.sort(
            (key, jnp.arange(xyz.shape[0], dtype=jnp.int32)), num_keys=1
        )
        self.sorted_xyz = xyz[self.order]

    _B = 1024  # coords clipped to [0, 1023] per axis

    def _coords(self, p: jnp.ndarray) -> jnp.ndarray:
        c = jnp.floor((p - self.origin) / self.bucket_size).astype(jnp.int32)
        return jnp.clip(c, 0, self._B - 1)

    def _key(self, c: jnp.ndarray) -> jnp.ndarray:
        return (c[..., 0] * self._B + c[..., 1]) * self._B + c[..., 2]

    def candidates(
        self, queries: jnp.ndarray, per_bucket: int = 8
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Candidate point indices from the 27 neighboring buckets.

        Returns (cand_idx i32[Q, 27*M] into the original cloud, valid bool).
        """
        qc = self._coords(queries)
        out_idx = []
        out_valid = []
        n = self.sorted_key.shape[0]
        for off in _NEIGHBOR_OFFSETS:
            nb = qc + jnp.asarray(off, dtype=jnp.int32)
            ok = jnp.all((nb >= 0) & (nb < self._B), axis=-1)
            key = self._key(nb)
            start = jnp.searchsorted(self.sorted_key, key, side="left")
            end = jnp.searchsorted(self.sorted_key, key, side="right")
            for m in range(per_bucket):
                pos = start + m
                valid = ok & (pos < end)
                pos = jnp.clip(pos, 0, n - 1)
                out_idx.append(jnp.where(valid, self.order[pos], -1))
                out_valid.append(valid)
        return jnp.stack(out_idx, axis=1), jnp.stack(out_valid, axis=1)

    def knn(
        self, queries: jnp.ndarray, k: int, per_bucket: int = 8,
        exclude_self_idx: Optional[jnp.ndarray] = None,
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        cand, valid = self.candidates(queries, per_bucket)
        cpts = self.xyz[jnp.maximum(cand, 0)]
        d2 = jnp.sum((cpts - queries[:, None, :]) ** 2, axis=-1)
        d2 = jnp.where(valid, d2, _INF)
        if exclude_self_idx is not None:
            d2 = jnp.where(cand == exclude_self_idx[:, None], _INF, d2)
        d2k, pos = _masked_topk_small(d2, k)
        idx = jnp.take_along_axis(cand, pos, axis=1)
        idx = jnp.where(jnp.isfinite(d2k), idx, -1)
        return idx, jnp.sqrt(jnp.maximum(d2k, 0.0))

    def radius_count(
        self, queries: jnp.ndarray, radius: float, per_bucket: int = 8,
        exclude_self_idx: Optional[jnp.ndarray] = None,
    ) -> jnp.ndarray:
        """Number of points within radius (exact when bucket_size >= radius
        and no bucket overflows per_bucket)."""
        cand, valid = self.candidates(queries, per_bucket)
        cpts = self.xyz[jnp.maximum(cand, 0)]
        d2 = jnp.sum((cpts - queries[:, None, :]) ** 2, axis=-1)
        ok = valid & (d2 <= radius * radius)
        if exclude_self_idx is not None:
            ok = ok & (cand != exclude_self_idx[:, None])
        return jnp.sum(ok, axis=1)


class DenseGrid:
    """Dense-CSR voxel grid for EXACT sub-quadratic kNN (build once on the
    host, query on device).

    Build (host-driven, device-executed): tight grid dims from the masked
    bounding box with a one-bucket empty margin on every side; points
    lex-sorted by (x, y, z) bucket key; per-cell point counts by
    segment-sum; CSR ``starts`` (cell id -> first sorted position) by
    cumsum. Because the key is lex with z fastest, the 3-bucket z-window
    of any (x, y) column is ONE contiguous span of the sorted array:
    ``[starts[key(cx,cy,cz-1)], starts[key(cx,cy,cz-1)+3])``. A query's
    27-bucket neighborhood is therefore NINE contiguous row slices — nine
    size-[cap] dynamic-slice gathers per query chunk instead of 27
    per-bucket element gathers.

    Exactness certificate (per query): the top-k over the column
    candidates is the TRUE kNN iff (a) no visited column span exceeded
    ``cap`` (no candidate was dropped) and (b) the kth distance is <=
    ``bucket_size`` — a query lies inside its own bucket, so any point
    outside the 3x3x3 neighborhood is farther than one bucket side
    (nanoflann's ball-within-bounds termination,
    lib/nanoPCL/thirdparty/nanoflann/nanoflann.hpp searchLevel). Callers
    (knn_grid) re-run only the failing queries through the exact brute
    tile.

    The reference structure is nanoPCL's KdTree (nanoflann wrapper,
    search/kdtree.hpp:20-49); this is its data-parallel equivalent: O(log N)
    per-query traversal is replaced by O(1) table lookups + a fixed-width
    candidate reduction, exactness kept via the certificate + fallback.
    """

    def __init__(
        self,
        xyz: jnp.ndarray,
        mask: jnp.ndarray,
        bucket_size: float,
        max_cells: int = 4_000_000,
        dims: Optional[Tuple[int, int, int]] = None,
        origin: Optional[jnp.ndarray] = None,
    ):
        self.xyz = xyz
        self.mask = mask
        n = xyz.shape[0]
        if dims is None or origin is None:
            bucket_size, dims, origin_np = _grid_geometry(
                xyz, mask, bucket_size, max_cells
            )
            origin = jnp.asarray(origin_np)
        self.bucket_size = float(bucket_size)
        self.origin = origin
        self.dims = tuple(int(d) for d in dims)
        nx, ny, nz = self.dims
        self.ncells = nx * ny * nz

        coords = self._coords(xyz)
        key = self._key(coords)
        key = jnp.where(mask, key, jnp.int32(self.ncells))  # invalid tail
        self.sorted_key, self.order = jax.lax.sort(
            (key, jnp.arange(n, dtype=jnp.int32)), num_keys=1
        )
        counts = jax.ops.segment_sum(
            mask.astype(jnp.int32), key, num_segments=self.ncells + 1
        )[: self.ncells]
        self.starts = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(counts).astype(jnp.int32)]
        )  # [ncells + 1]
        # Sorted coordinates, padded so a dynamic slice starting anywhere
        # in [0, n] stays in range; pad rows are far-away sentinels.
        self.sorted_xyz = xyz[self.order]
        # Inverse permutation: original index -> sorted position (for
        # self-exclusion without an extra gather).
        self.inv_order = (
            jnp.zeros(n, dtype=jnp.int32)
            .at[self.order]
            .set(jnp.arange(n, dtype=jnp.int32))
        )

    def _coords(self, p: jnp.ndarray) -> jnp.ndarray:
        c = jnp.floor(
            (p - self.origin) / self.bucket_size
        ).astype(jnp.int32)
        return jnp.clip(
            c, 1, jnp.asarray(self.dims, dtype=jnp.int32) - 2
        )

    def _key(self, c: jnp.ndarray) -> jnp.ndarray:
        nx, ny, nz = self.dims
        return (c[..., 0] * ny + c[..., 1]) * nz + c[..., 2]

    def _neighbor_tables(self, m: int, cell_chunk: int):
        """Shared dense-table construction for knn_table/radius_table.

        Scatters the sorted points into [ncells, m] xyz/id tables plus a
        per-cell count vector, padded so that EVERY chunked neighbor
        slice stays in bounds: chunk starts run to ncells + nc_pad -
        cell_chunk (cell_chunk-aligned sweep) and the largest positive
        neighbor offset is pad_cells, so the HIGH side needs pad_cells +
        nc_pad rows — padding only pad_cells let the final chunk's
        positive-offset slices clamp and fetch WRONG cells whenever
        ncells % cell_chunk != 0, silently certified exact (r5 review
        finding; regression-tested on elongated grids).

        Returns (ok_slot, flat, valid_s, tblp, idsp, cntp, offsets,
        pad_lo, nc_pad, n_chunks).
        """
        n = self.xyz.shape[0]
        nx, ny, nz = self.dims
        ncells = self.ncells
        key_s = self.sorted_key  # [n], invalid tail = ncells
        valid_s = key_s < ncells
        counts = self.starts[1:] - self.starts[:-1]  # [ncells]
        # Within-bucket slot of each sorted point (sorted => contiguous).
        slot = jnp.arange(n, dtype=jnp.int32) - self.starts[
            jnp.minimum(key_s, ncells - 1)
        ]
        ok_slot = valid_s & (slot < m)
        flat = jnp.where(
            ok_slot, jnp.minimum(key_s, ncells - 1) * m + slot,
            ncells * m,
        )
        tbl = (
            jnp.full((ncells * m + 1, 3), 1e9, jnp.float32)
            .at[flat]
            .set(jnp.where(ok_slot[:, None], self.sorted_xyz, 1e9))[:-1]
            .reshape(ncells, m, 3)
        )
        ids = (
            jnp.full((ncells * m + 1,), -1, jnp.int32)
            .at[flat]
            .set(jnp.where(ok_slot, self.order, -1))[:-1]
            .reshape(ncells, m)
        )
        pad_lo = ny * nz + nz + 1  # max |linear offset| of (+-1,+-1,+-1)
        nc_pad = (-ncells) % cell_chunk
        n_chunks = (ncells + nc_pad) // cell_chunk
        pad_hi = pad_lo + nc_pad
        tblp = jnp.concatenate([
            jnp.full((pad_lo, m, 3), 1e9, jnp.float32),
            tbl,
            jnp.full((pad_hi, m, 3), 1e9, jnp.float32),
        ])
        idsp = jnp.concatenate([
            jnp.full((pad_lo, m), -1, jnp.int32),
            ids,
            jnp.full((pad_hi, m), -1, jnp.int32),
        ])
        cntp = jnp.concatenate([
            jnp.zeros(pad_lo, jnp.int32),
            counts,
            jnp.zeros(pad_hi, jnp.int32),
        ])
        offsets = [
            (dx * ny + dy) * nz + dz
            for dx in (-1, 0, 1)
            for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)
        ]
        return (ok_slot, flat, valid_s, tblp, idsp, cntp, offsets,
                pad_lo, nc_pad, n_chunks)

    def knn_table(
        self,
        k: int,
        m: int = 32,
        cell_chunk: int = 256,
    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Self-kNN over the whole cloud via the DENSE bucket table: zero
        per-query gathers.

        A per-query slice fetch is a vmapped dynamic-slice gather that
        XLA executes per ELEMENT (9 cols x cap x 3 floats x N). Here the
        sorted points are scattered ONCE into a dense [ncells, m] table
        (one row scatter); a cell-range chunk's 27
        neighbor buckets are then CONTIGUOUS rows of that table (the
        z-fastest lex key makes (dx,dy,dz) a static linear offset), so
        candidate fetch is 27 dynamic slices of dense memory per chunk —
        dense elementwise work, no per-element indices. Distances, the masked
        top-k, and the neighbor-id selection are all dense passes;
        results scatter back by two row scatters.

        Returns (idx i32[N, k], dist f32[N, k], exact bool[N]) in
        ORIGINAL point order. exact certifies the row like knn():
        no involved bucket overflowed ``m`` AND kth distance <=
        bucket_size. Masked points report idx=-1/dist=inf/exact=True
        (nothing to search).
        """
        n = self.xyz.shape[0]
        ncells = self.ncells
        b2 = jnp.float32(self.bucket_size * self.bucket_size)
        (ok_slot, flat, valid_s, tblp, idsp, cntp, offsets, pad_lo,
         nc_pad, n_chunks) = self._neighbor_tables(m, cell_chunk)
        lanes = 27 * m

        def one_chunk(c0):
            q = jax.lax.dynamic_slice(
                tblp, (pad_lo + c0, 0, 0), (cell_chunk, m, 3)
            )  # [C, m, 3]
            all_d2, all_id = [], []
            overflow = jnp.zeros((cell_chunk,), bool)
            for j, off in enumerate(offsets):
                cand = jax.lax.dynamic_slice(
                    tblp, (pad_lo + c0 + off, 0, 0),
                    (cell_chunk, m, 3),
                )
                cid = jax.lax.dynamic_slice(
                    idsp, (pad_lo + c0 + off, 0), (cell_chunk, m)
                )
                ccnt = jax.lax.dynamic_slice(
                    cntp, (pad_lo + c0 + off,), (cell_chunk,)
                )
                overflow = overflow | (ccnt > m)
                diff = q[:, :, None, :] - cand[:, None, :, :]
                d2 = jnp.sum(diff * diff, axis=-1)  # [C, m, m]
                d2 = jnp.where((cid >= 0)[:, None, :], d2, _INF)
                if off == 0:
                    eye = jnp.eye(m, dtype=bool)
                    d2 = jnp.where(eye[None], _INF, d2)
                all_d2.append(d2)
                all_id.append(
                    jnp.broadcast_to(cid[:, None, :], d2.shape)
                )
            cat_d = jnp.concatenate(all_d2, axis=2)  # [C, m, 27m]
            cat_i = jnp.concatenate(all_id, axis=2)
            # k dense extraction passes; ids selected by one-hot sum in
            # the same pass (no per-index gathers anywhere).
            iota = jax.lax.broadcasted_iota(
                jnp.int32, cat_d.shape, 2
            )
            ds, sel_ids = [], []
            cur = cat_d
            for _ in range(min(k, lanes)):
                amin = jnp.argmin(cur, axis=2).astype(jnp.int32)
                hot = iota == amin[..., None]
                ds.append(jnp.min(cur, axis=2))
                # One-hot id select rides the same sweep; all-inf rows
                # are corrected to -1 by the isfinite(d2k) mask below.
                sel_ids.append(jnp.sum(jnp.where(hot, cat_i, 0), axis=2))
                cur = jnp.where(hot, _INF, cur)
            d2k = jnp.stack(ds, axis=2)  # [C, m, k']
            idk = jnp.stack(sel_ids, axis=2)
            if k > lanes:
                padw = k - lanes
                d2k = jnp.concatenate(
                    [d2k, jnp.full(d2k.shape[:2] + (padw,), _INF)],
                    axis=2,
                )
                idk = jnp.concatenate(
                    [idk,
                     jnp.full(idk.shape[:2] + (padw,), -1, jnp.int32)],
                    axis=2,
                )
            idk = jnp.where(jnp.isfinite(d2k), idk, -1)
            got_k = jnp.isfinite(d2k[..., -1])
            exact = jnp.logical_not(overflow)[:, None] & got_k & (
                d2k[..., -1] <= b2
            )
            return d2k, idk, exact

        c0s = jnp.arange(n_chunks, dtype=jnp.int32) * cell_chunk
        d2k, idk, exact = jax.lax.map(one_chunk, c0s)
        d2k = d2k.reshape(-1, m, k)[:ncells]
        idk = idk.reshape(-1, m, k)[:ncells]
        exact = exact.reshape(-1, m)[:ncells]

        # Back to sorted order (slot -> sorted position is the identity
        # starts[c] + i by construction), then to original order — two
        # row scatters, ~n indices each.
        out_d = jnp.full((n + 1, k), _INF, jnp.float32)
        out_i = jnp.full((n + 1, k), -1, jnp.int32)
        out_e = jnp.ones((n + 1,), bool)
        d_flat = d2k.reshape(ncells * m, k)
        i_flat = idk.reshape(ncells * m, k)
        e_flat = exact.reshape(ncells * m)
        sel = jnp.where(ok_slot, flat, ncells * m - 1)
        orig = jnp.where(valid_s, self.order, n)
        out_d = out_d.at[orig].set(
            jnp.where(ok_slot[:, None], d_flat[sel], _INF)
        )
        out_i = out_i.at[orig].set(
            jnp.where(ok_slot[:, None], i_flat[sel], -1)
        )
        out_e = out_e.at[orig].set(
            ok_slot & e_flat[sel]
        )
        return (
            out_i[:n],
            jnp.sqrt(jnp.maximum(out_d[:n], 0.0)),
            out_e[:n] | jnp.logical_not(self.mask),
        )

    def radius_table(
        self,
        radius: float,
        max_neighbors: int,
        m: int = 32,
        cell_chunk: int = 256,
    ):
        """Exact self radius search via the dense bucket table.

        Requires ``radius <= bucket_size`` (build the grid with
        bucket_size=radius and the 27-neighborhood provably contains the
        whole ball — no kth-distance condition needed, unlike kNN). The
        certificate is overflow-only: a row is exact unless one of its
        27 buckets held more than ``m`` points.

        Returns (idx i32[N, max_neighbors] distance-sorted ascending,
        dist f32[N, max_neighbors], count i32[N] EXACT in-radius count
        capped only by overflow, exact bool[N]) in original point order;
        self excluded. Masked rows: empty + exact=True.
        """
        if radius > self.bucket_size + 1e-6:
            raise ValueError(
                f"radius_table needs radius <= bucket_size "
                f"({radius} > {self.bucket_size})"
            )
        n = self.xyz.shape[0]
        ncells = self.ncells
        r2 = jnp.float32(radius * radius)
        (ok_slot, flat, valid_s, tblp, idsp, cntp, offsets, pad_lo,
         nc_pad, n_chunks) = self._neighbor_tables(m, cell_chunk)
        cap = min(max_neighbors, 27 * m)

        def one_chunk(c0):
            q = jax.lax.dynamic_slice(
                tblp, (pad_lo + c0, 0, 0), (cell_chunk, m, 3)
            )
            all_d2, all_id = [], []
            overflow = jnp.zeros((cell_chunk,), bool)
            for off in offsets:
                cand = jax.lax.dynamic_slice(
                    tblp, (pad_lo + c0 + off, 0, 0),
                    (cell_chunk, m, 3),
                )
                cid = jax.lax.dynamic_slice(
                    idsp, (pad_lo + c0 + off, 0), (cell_chunk, m)
                )
                ccnt = jax.lax.dynamic_slice(
                    cntp, (pad_lo + c0 + off,), (cell_chunk,)
                )
                overflow = overflow | (ccnt > m)
                diff = q[:, :, None, :] - cand[:, None, :, :]
                d2 = jnp.sum(diff * diff, axis=-1)
                d2 = jnp.where((cid >= 0)[:, None, :], d2, _INF)
                if off == 0:
                    d2 = jnp.where(
                        jnp.eye(m, dtype=bool)[None], _INF, d2
                    )
                d2 = jnp.where(d2 <= r2, d2, _INF)
                all_d2.append(d2)
                all_id.append(
                    jnp.broadcast_to(cid[:, None, :], d2.shape)
                )
            cat_d = jnp.concatenate(all_d2, axis=2)
            cat_i = jnp.concatenate(all_id, axis=2)
            count = jnp.sum(jnp.isfinite(cat_d), axis=2).astype(
                jnp.int32
            )
            iota = jax.lax.broadcasted_iota(jnp.int32, cat_d.shape, 2)
            ds, sel_ids = [], []
            cur = cat_d
            for _ in range(cap):
                amin = jnp.argmin(cur, axis=2).astype(jnp.int32)
                hot = iota == amin[..., None]
                ds.append(jnp.min(cur, axis=2))
                sel_ids.append(jnp.sum(jnp.where(hot, cat_i, 0), axis=2))
                cur = jnp.where(hot, _INF, cur)
            d2k = jnp.stack(ds, axis=2)
            idk = jnp.stack(sel_ids, axis=2)
            idk = jnp.where(jnp.isfinite(d2k), idk, -1)
            exact = jnp.logical_not(overflow)
            return d2k, idk, count, exact

        c0s = jnp.arange(n_chunks, dtype=jnp.int32) * cell_chunk
        d2k, idk, count, exact = jax.lax.map(one_chunk, c0s)
        d2k = d2k.reshape(-1, m, cap)[:ncells]
        idk = idk.reshape(-1, m, cap)[:ncells]
        count = count.reshape(-1, m)[:ncells]
        exact = exact.reshape(-1)[:ncells]

        out_d = jnp.full((n + 1, cap), _INF, jnp.float32)
        out_i = jnp.full((n + 1, cap), -1, jnp.int32)
        out_c = jnp.zeros((n + 1,), jnp.int32)
        out_e = jnp.ones((n + 1,), bool)
        sel = jnp.where(ok_slot, flat, ncells * m - 1)
        orig = jnp.where(valid_s, self.order, n)
        d_flat = d2k.reshape(ncells * m, cap)
        i_flat = idk.reshape(ncells * m, cap)
        c_flat = count.reshape(ncells * m)
        e_cell = exact[jnp.minimum(self.sorted_key, ncells - 1)]
        out_d = out_d.at[orig].set(
            jnp.where(ok_slot[:, None], d_flat[sel], _INF)
        )
        out_i = out_i.at[orig].set(
            jnp.where(ok_slot[:, None], i_flat[sel], -1)
        )
        out_c = out_c.at[orig].set(
            jnp.where(ok_slot, c_flat[sel], 0)
        )
        out_e = out_e.at[orig].set(ok_slot & e_cell)
        d = jnp.sqrt(jnp.maximum(out_d[:n], 0.0))
        idx, cnt, ex = out_i[:n], out_c[:n], out_e[:n]
        if cap < max_neighbors:
            padw = max_neighbors - cap
            d = jnp.concatenate(
                [d, jnp.full((n, padw), _INF)], axis=1
            )
            idx = jnp.concatenate(
                [idx, jnp.full((n, padw), -1, jnp.int32)], axis=1
            )
        return idx, d, cnt, ex | jnp.logical_not(self.mask)

    def knn(
        self,
        queries: jnp.ndarray,
        k: int,
        cap: int = 64,
        self_pos: Optional[jnp.ndarray] = None,
        chunk: int = 4096,
    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Candidate-column kNN with exactness certificate.

        ``self_pos``: per-query SORTED position to exclude (pass
        ``grid.inv_order`` for self-kNN), or None.

        Returns (idx i32[Q, k] into the original cloud, dist f32[Q, k],
        exact bool[Q]). Entries beyond the kth neighbor are idx=-1 /
        dist=inf; ``exact[i]`` certifies idx[i]/dist[i] is the true kNN.
        """
        n = self.xyz.shape[0]
        nz = self.dims[2]
        capc = min(cap, n)
        b2 = jnp.float32(self.bucket_size * self.bucket_size)
        pad_xyz = jnp.concatenate(
            [self.sorted_xyz, jnp.full((capc, 3), 1e9, jnp.float32)]
        )
        order_pad = jnp.concatenate(
            [self.order, jnp.full(capc, -1, jnp.int32)]
        )
        col_iota = jnp.arange(capc, dtype=jnp.int32)
        offsets = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]

        def one_chunk(qc_in):
            qq, spos = qc_in  # [B, 3], [B]
            qc = self._coords(qq)
            base_key = self._key(qc)  # column key of the (0, 0, z) bucket
            all_d2, all_pos, overflow = [], [], jnp.zeros(
                qq.shape[0], dtype=bool
            )
            for dx, dy in offsets:
                ck = base_key + (dx * self.dims[1] + dy) * nz - 1
                start = self.starts[ck]
                end = self.starts[ck + 3]
                overflow = overflow | ((end - start) > capc)
                pts = jax.vmap(
                    lambda s: jax.lax.dynamic_slice(
                        pad_xyz, (s, 0), (capc, 3)
                    )
                )(start)  # [B, cap, 3]
                pos = start[:, None] + col_iota[None, :]
                valid = pos < end[:, None]
                diff = pts - qq[:, None, :]
                d2 = jnp.sum(diff * diff, axis=-1)
                d2 = jnp.where(valid, d2, _INF)
                if self_pos is not None:
                    d2 = jnp.where(pos == spos[:, None], _INF, d2)
                all_d2.append(d2)
                all_pos.append(pos)
            cat_d = jnp.concatenate(all_d2, axis=1)
            cat_p = jnp.concatenate(all_pos, axis=1)
            kk = min(k, cat_d.shape[1])
            d2k, sel = _masked_topk_small(cat_d, kk)
            pos_sel = jnp.take_along_axis(cat_p, sel, axis=1)
            idx = jnp.where(
                jnp.isfinite(d2k), order_pad[jnp.clip(pos_sel, 0, n)], -1
            )
            got_k = jnp.isfinite(d2k[:, -1])
            exact = (
                jnp.logical_not(overflow) & got_k & (d2k[:, -1] <= b2)
            )
            if kk < k:
                padw = k - kk
                d2k = jnp.concatenate(
                    [d2k, jnp.full((d2k.shape[0], padw), _INF)], axis=1
                )
                idx = jnp.concatenate(
                    [idx, jnp.full((idx.shape[0], padw), -1, jnp.int32)],
                    axis=1,
                )
            return d2k, idx, exact

        nq = queries.shape[0]
        pad = (-nq) % chunk
        qp = jnp.concatenate(
            [queries, jnp.full((pad, 3), 1e9, dtype=queries.dtype)]
        ).reshape(-1, chunk, 3)
        spos = (
            self_pos
            if self_pos is not None
            else jnp.full(nq, -1, jnp.int32)
        )
        spos = jnp.concatenate(
            [spos.astype(jnp.int32), jnp.full(pad, -1, jnp.int32)]
        ).reshape(-1, chunk)
        d2, idx, exact = jax.lax.map(one_chunk, (qp, spos))
        d2 = d2.reshape(-1, k)[:nq]
        idx = idx.reshape(-1, k)[:nq]
        exact = exact.reshape(-1)[:nq]
        return idx, jnp.sqrt(jnp.maximum(d2, 0.0)), exact


def _grid_geometry(xyz, mask, bucket_size: float, max_cells: int):
    """Host-side grid geometry: masked bbox -> (bucket_size, dims, origin).
    Grows the bucket if the tight grid would exceed ``max_cells`` (keeps
    the CSR table dense-indexable)."""
    import numpy as np

    pts = np.asarray(xyz)[np.asarray(mask)]
    if pts.shape[0] == 0:
        pts = np.zeros((1, 3), np.float32)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    b = float(bucket_size)
    while True:
        dims = np.maximum(np.ceil((hi - lo) / b + 1e-6), 1).astype(
            np.int64
        ) + 2  # one-bucket margin each side
        if int(dims.prod()) <= max_cells:
            break
        b *= 1.5
    return b, tuple(int(d) for d in dims), (lo - b).astype(np.float32)


# jitted whole-pass closures keyed by their static configuration (a fresh
# jax.jit wrapper per call would defeat the dispatch cache and re-trace
# every call — same reasoning as registration._step_fns_cached). BOUNDED:
# grid dims are per-cloud, so a long-running node whose bbox drifts every
# frame would otherwise grow this (and the compiled executables it pins)
# without limit.
_GRID_JIT_CACHE: dict = {}
_GRID_JIT_CACHE_MAX = 64


def _grid_jit_cache_put(key, fn):
    if len(_GRID_JIT_CACHE) >= _GRID_JIT_CACHE_MAX:
        _GRID_JIT_CACHE.pop(next(iter(_GRID_JIT_CACHE)))  # FIFO evict
    _GRID_JIT_CACHE[key] = fn


def _grid_knn_pass(dims, bucket_size, k, cap, self_exclude, max_cells):
    """One jitted program: build the CSR grid AND run the candidate query
    (sort + segment-sum + cumsum + 9 column slices + top-k) — a single
    device dispatch per knn_grid call (the host only decides geometry and
    the certificate fallback)."""
    key = (dims, round(bucket_size, 9), k, cap, self_exclude)
    fn = _GRID_JIT_CACHE.get(key)
    if fn is None:

        @jax.jit
        def fn(xyz, mask, origin, queries):
            grid = DenseGrid(
                xyz, mask, bucket_size, max_cells=max_cells, dims=dims,
                origin=origin,
            )
            self_pos = grid.inv_order if self_exclude else None
            return grid.knn(queries, k, cap=cap, self_pos=self_pos)

        _grid_jit_cache_put(key, fn)
    return fn


def _grid_table_pass(dims, bucket_size, k, m, max_cells, tail=None):
    """One jitted program for the dense-table SELF-kNN (knn_table),
    optionally fused with a ``tail(xyz, idx, *tail_args)`` consumer
    (normals / covariance PCA) so the whole pipeline is ONE dispatch."""
    key = ("table", dims, round(bucket_size, 9), k, m, tail)
    fn = _GRID_JIT_CACHE.get(key)
    if fn is None:

        @jax.jit
        def fn(xyz, mask, origin, *tail_args):
            grid = DenseGrid(
                xyz, mask, bucket_size, max_cells=max_cells, dims=dims,
                origin=origin,
            )
            idx, dist, exact = grid.knn_table(k, m=m)
            if tail is None:
                return idx, dist, exact, ()
            return idx, dist, exact, tail(xyz, idx, *tail_args)

        _grid_jit_cache_put(key, fn)
    return fn


def _auto_bucket_size(xyz, mask, k: int, sample: int = 512) -> float:
    """Bucket side targeting ~90% certificate hits, measured not modeled:
    brute-kNN a small random sample against the full cloud and take 1.2x
    the 90th percentile of kth-neighbor distances. (A uniform-density
    formula badly overestimates the bucket for 2.5D surface scans — the
    points concentrate on a sheet, so volume density says 'sparse' while
    every column overflows.) Cost: sample/N of one brute pass."""
    import numpy as np

    mask_np = np.asarray(mask)
    n_valid = int(mask_np.sum())
    if n_valid <= k + 1:
        return 1.0
    valid_idx = np.nonzero(mask_np)[0]
    rng = np.random.default_rng(0)
    s = min(sample, n_valid)
    sel = valid_idx[rng.choice(n_valid, s, replace=False)]
    q = jnp.asarray(np.asarray(xyz)[sel])
    _, d = _knn_brute_jit(
        xyz, mask, k, queries=q, exclude_self=True,
        self_indices=jnp.asarray(sel.astype(np.int32)),
    )
    dk = np.asarray(d)[:, -1]
    dk = dk[np.isfinite(dk)]
    if dk.size == 0:
        return 1.0
    return float(max(1.2 * np.percentile(dk, 90), 1e-3))


def knn_grid(
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    k: int,
    bucket_size: Optional[float] = None,
    cap: int = 64,
    queries: Optional[jnp.ndarray] = None,
    exclude_self: bool = True,
    tail=None,
    tail_args: tuple = (),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """EXACT kNN via the dense-grid candidate pass + brute fallback on the
    queries whose certificate fails (sparse regions / overflowing columns).

    Host-driven (the certificate decides a data-dependent second pass), so
    NOT traceable under jit — large offline callers (normals, SOR,
    registration prep) are host-level anyway; in-jit users take
    ``knn_brute``. Cost: one sort + 9 row-slice gathers + top-k for all
    queries, plus the O(N) brute tile for only the failing fraction.

    ``tail``: optional traceable consumer ``tail(xyz, idx, *tail_args)``
    FUSED into the table pass (self-kNN only) so e.g. kNN + PCA normals
    is one device dispatch; when any certificate fails, the tail re-runs
    once on the merged exact idx. With a tail the return is
    (idx, dist, tail_out).
    """
    import numpy as np

    from fastdem_tpu.cloud.pointcloud import ladder_capacity

    q = xyz if queries is None else queries
    if bucket_size is None:
        bucket_size = _auto_bucket_size(xyz, mask, k)
    bucket_size, dims, origin = _grid_geometry(
        xyz, mask, bucket_size, 4_000_000
    )
    ncells = dims[0] * dims[1] * dims[2]
    m = 0
    if queries is None and exclude_self:
        # Self-kNN hot path: the dense-table formulation (zero per-query
        # gathers). Per-bucket capacity m from the host-side occupancy
        # distribution; overflowing buckets' members fail the certificate
        # and take the brute fallback.
        c = np.floor(
            (np.asarray(xyz)[np.asarray(mask)] - origin) / bucket_size
        ).astype(np.int64)
        keys = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
        _, cnts = np.unique(keys, return_counts=True)
        p995 = float(np.percentile(cnts, 99.5)) if cnts.size else 8.0
        m = int(min(64, max(8, -(-int(p995) // 8) * 8)))
    # The dense table is [ncells, m]: wide bounding boxes (outliers) with
    # small buckets can blow ncells up to max_cells, and a multi-GB table
    # helps nobody — bound the footprint and fall back to the per-query
    # pass (still exact; starts[] is only 4 B/cell).
    tail_out = None
    if m and ncells * m <= 16_000_000:
        fn = _grid_table_pass(dims, bucket_size, k, m, 4_000_000,
                              tail=tail)
        idx, dist, exact, tail_out = fn(
            xyz, mask, jnp.asarray(origin), *tail_args
        )
    else:
        fn = _grid_knn_pass(
            dims, bucket_size, k, cap, queries is None and exclude_self,
            4_000_000,
        )
        idx, dist, exact = fn(xyz, mask, jnp.asarray(origin), q)
        if tail is not None:
            tail_out = tail(xyz, idx, *tail_args)
    exact_np = np.asarray(exact)
    # Invalid (masked) self-queries report garbage either way; don't pay
    # brute for them.
    if queries is None:
        exact_np = exact_np | ~np.asarray(mask)
    n_fail = int((~exact_np).sum())
    if n_fail == 0:
        if tail is not None:
            return idx, dist, tail_out
        return idx, dist
    fail = np.nonzero(~exact_np)[0]
    capn = min(ladder_capacity(n_fail), q.shape[0])
    fail_pad = np.concatenate(
        [fail, np.full(capn - n_fail, fail[0], dtype=fail.dtype)]
    )
    fq = jnp.asarray(np.asarray(q)[fail_pad])
    self_idx = None
    if queries is None and exclude_self:
        self_idx = jnp.asarray(fail_pad.astype(np.int32))
    bi, bd = _knn_brute_jit(
        xyz, mask, k, queries=fq, exclude_self=self_idx is not None,
        self_indices=self_idx,
    )
    idx = idx.at[jnp.asarray(fail)].set(bi[:n_fail])
    dist = dist.at[jnp.asarray(fail)].set(bd[:n_fail])
    if tail is not None:
        # One extra dispatch only on fallback: the tail re-runs on the
        # merged exact neighbor lists.
        return idx, dist, tail(xyz, idx, *tail_args)
    return idx, dist


def _grid_radius_pass(dims, bucket_size, radius, max_neighbors, m,
                      max_cells):
    key = ("radius", dims, round(bucket_size, 9), round(radius, 9),
           max_neighbors, m)
    fn = _GRID_JIT_CACHE.get(key)
    if fn is None:

        @jax.jit
        def fn(xyz, mask, origin):
            grid = DenseGrid(
                xyz, mask, bucket_size, max_cells=max_cells, dims=dims,
                origin=origin,
            )
            return grid.radius_table(radius, max_neighbors, m=m)

        _grid_jit_cache_put(key, fn)
    return fn


def radius_search_grid(
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    radius: float,
    max_neighbors: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """EXACT self radius search at scale: dense bucket table with
    bucket_size = radius (the 27-neighborhood provably contains the whole
    ball), overflow-only certificate, brute fallback for failing rows.
    Host-driven like knn_grid (not traceable under jit). Masked rows
    return empty results (same contract as knn).

    Returns (idx i32[N, max_neighbors] distance-sorted, dist f32[N,
    max_neighbors], count i32[N] exact in-radius count).
    """
    import numpy as np

    from fastdem_tpu.cloud.pointcloud import ladder_capacity

    n = xyz.shape[0]
    bucket_size, dims, origin = _grid_geometry(
        xyz, mask, float(radius), 4_000_000
    )
    ncells = dims[0] * dims[1] * dims[2]
    if bucket_size > radius + 1e-6:
        m = 10 ** 9  # bbox forced bigger buckets: table invalid
    else:
        c = np.floor(
            (np.asarray(xyz)[np.asarray(mask)] - origin) / bucket_size
        ).astype(np.int64)
        keys = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
        _, cnts = np.unique(keys, return_counts=True)
        # Unlike kNN (where overflowing rows are rare and cheap to fall
        # back), the bucket here is PINNED to the radius, and ONE
        # overflowing bucket poisons the certificate of its whole
        # 27-neighborhood — a p99.5 cap sent 98.8% of a dense cloud
        # through the brute fallback (r5). Size m to the MAX occupancy
        # so overflow (and the fallback) cannot happen, and hand the
        # dense-ball regime (max occupancy > 128: radius >> spacing)
        # straight to the brute tile, which wins there anyway.
        mx = int(cnts.max()) if cnts.size else 1
        m = int(max(8, -(-mx // 8) * 8))
    if m <= 128 and ncells * m <= 16_000_000:
        fn = _grid_radius_pass(
            dims, bucket_size, float(radius), max_neighbors, m, 4_000_000
        )
        idx, dist, cnt, exact = fn(xyz, mask, jnp.asarray(origin))
        exact_np = np.asarray(exact)
    else:
        idx = jnp.full((n, max_neighbors), -1, jnp.int32)
        dist = jnp.full((n, max_neighbors), _INF)
        cnt = jnp.zeros((n,), jnp.int32)
        exact_np = ~np.asarray(mask)  # only masked rows are "done"
    n_fail = int((~exact_np).sum())
    if n_fail == 0:
        return idx, dist, cnt
    fail = np.nonzero(~exact_np)[0]
    capn = min(ladder_capacity(n_fail), n)
    fail_pad = np.concatenate(
        [fail, np.full(capn - n_fail, fail[0], dtype=fail.dtype)]
    )
    fq = jnp.asarray(np.asarray(xyz)[fail_pad])
    bi, bd, bc = radius_search_brute(
        xyz, mask, float(radius), max_neighbors, queries=fq,
        exclude_self=True,
        self_indices=jnp.asarray(fail_pad.astype(np.int32)),
    )
    idx = idx.at[jnp.asarray(fail)].set(bi[:n_fail])
    dist = dist.at[jnp.asarray(fail)].set(bd[:n_fail])
    cnt = cnt.at[jnp.asarray(fail)].set(bc[:n_fail])
    return idx, dist, cnt


def knn(
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    k: int,
    bucket_size: Optional[float] = None,
    method: str = "auto",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Self-kNN over the cloud (each point's k nearest other points).

    Results for MASKED rows are undefined — the grid path returns
    idx=-1/dist=inf for them (padded sentinel points must not cost
    search work), the brute path happens to fill them; no consumer reads
    masked rows (SOR/normals re-mask downstream).

    Every method here is EXACT except "bucket":

      * "auto": exact always — the sub-quadratic grid+certificate path
        (knn_grid) above ``_GRID_CROSSOVER`` points, the brute tile below
        it or whenever the inputs are tracers (the grid path is
        host-driven and cannot run under jit).
      * "brute": doubly-tiled exact tile at any N (jit-safe).
      * "grid": force the grid+fallback exact path.
      * "bucket": capped 27-neighborhood candidates — approximate on
        bucket overflow; latency-bound callers opt in explicitly."""
    n = xyz.shape[0]
    if method == "auto":
        concrete = not (
            isinstance(xyz, jax.core.Tracer)
            or isinstance(mask, jax.core.Tracer)
        )
        method = (
            "grid" if (concrete and n >= _GRID_CROSSOVER) else "brute"
        )
    if method == "brute":
        return knn_brute(xyz, mask, k)
    if method == "grid":
        return knn_grid(xyz, mask, k, bucket_size=bucket_size)
    if method != "bucket":
        raise ValueError(f"unknown search method: {method!r}")
    if bucket_size is None:
        raise ValueError("bucket method requires bucket_size")
    grid = BucketGrid(xyz, mask, bucket_size)
    return grid.knn(
        xyz, k, exclude_self_idx=jnp.arange(n, dtype=jnp.int32)
    )
