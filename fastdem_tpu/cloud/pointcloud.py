"""Fixed-capacity SoA point cloud as a JAX pytree (nanoPCL equivalent).

Re-expresses ``nanopcl::PointCloud``
(/root/reference/fastdem/lib/nanoPCL/include/nanopcl/core/point_cloud.hpp:14-184)
for XLA: a structure-of-arrays container with optional named channels.

Deviations:
  * Fixed capacity + validity mask. XLA requires static shapes, so filters
    never compact; they intersect ``mask``. ``compact()`` (host-side) and
    ``pad_to()`` convert between exact-size and bucketed capacities.
  * ``frame_id``/``timestamp_ns`` are static metadata. Hot-path jitted
    functions must consume the array leaves (xyz/mask/channels) only —
    passing whole clouds with changing timestamps through ``jax.jit``
    causes retraces. The pipeline wrappers in fastdem_tpu.mapping.pipeline
    follow this rule.

Channels (same surface as nanoPCL core/types.hpp):
  intensity f32[N], time f32[N], ring i32[N], color u8[N, 3], label i32[N],
  normal f32[N, 3], covariance f32[N, 3, 3].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

CHANNEL_DTYPES = {
    "intensity": jnp.float32,
    "time": jnp.float32,
    "ring": jnp.int32,
    "color": jnp.uint8,
    "label": jnp.int32,
    "normal": jnp.float32,
    "covariance": jnp.float32,
}


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PointCloud:
    """SoA point cloud.

    Attributes:
      xyz: f32[N, 3] point coordinates.
      mask: bool[N] validity; False entries are padding / filtered out.
      channels: optional per-point channels (see CHANNEL_DTYPES).
      frame_id: sensor/world frame name (static metadata).
      timestamp_ns: acquisition time (static metadata; host-side use only).
    """

    xyz: jnp.ndarray
    mask: jnp.ndarray
    channels: Dict[str, jnp.ndarray]
    frame_id: str = dataclasses.field(default="", metadata=dict(static=True))
    timestamp_ns: int = dataclasses.field(default=0, metadata=dict(static=True))
    # Number of points provided at construction (before validity masking);
    # the host-side 'is this scan empty' check (reference PointCloud::empty)
    # without forcing a device sync. -1 = unknown.
    nominal_count: int = dataclasses.field(
        default=-1, metadata=dict(static=True)
    )
    # Number of mask-true points at construction, tracked host-side so the
    # facade can pick a capacity bucket WITHOUT a device sync (masked
    # scatter rows still pay per index — only real compaction helps, and
    # jit's static shapes make capacity the lever).
    # -1 = unknown (e.g. after a device-side with_mask).
    valid_count: int = dataclasses.field(
        default=-1, metadata=dict(static=True)
    )

    # -- host-side conveniences -------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self.xyz.shape[0])

    def count(self) -> int:
        """Number of valid points (device sync)."""
        return int(jnp.sum(self.mask))

    def empty(self) -> bool:
        """True when no points were provided (host-side, no device sync
        when nominal_count is known — the hot-path emptiness check)."""
        if self.nominal_count >= 0:
            return self.nominal_count == 0
        return self.capacity == 0 or self.count() == 0

    def has(self, channel: str) -> bool:
        return channel in self.channels

    def with_channel(self, name: str, value: jnp.ndarray) -> "PointCloud":
        ch = dict(self.channels)
        ch[name] = value
        return dataclasses.replace(self, channels=ch)

    def with_mask(self, mask: jnp.ndarray) -> "PointCloud":
        # The new mask's population is unknown host-side; invalidate the
        # construction-time count rather than risk a stale bucket choice.
        return dataclasses.replace(self, mask=mask, valid_count=-1)

    def with_frame(self, frame_id: str) -> "PointCloud":
        return dataclasses.replace(self, frame_id=frame_id)


def from_numpy(
    xyz: np.ndarray,
    frame_id: str = "",
    timestamp_ns: int = 0,
    capacity: Optional[int] = None,
    **channels: np.ndarray,
) -> PointCloud:
    """Build a cloud from host arrays, optionally padding to ``capacity``.

    Padding entries have mask=False and xyz filled with a far-away sentinel
    so accidental unmasked consumers map them out of any grid.
    """
    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    cap = capacity if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < point count {n}")
    mask = np.zeros(cap, dtype=bool)
    mask[:n] = True
    # NaN rows in the input are invalid points (reference skips NaN points).
    finite = np.isfinite(xyz).all(axis=1)
    mask[:n] &= finite
    pad_xyz = np.full((cap, 3), 1e9, dtype=np.float32)
    pad_xyz[:n] = np.where(finite[:, None], xyz, 1e9)
    ch_out: Dict[str, jnp.ndarray] = {}
    for name, data in channels.items():
        if data is None:
            continue
        if name not in CHANNEL_DTYPES:
            raise KeyError(f"unknown channel '{name}'")
        data = np.asarray(data)
        buf_shape = (cap,) + data.shape[1:]
        buf = np.zeros(buf_shape, dtype=data.dtype)
        buf[:n] = data
        ch_out[name] = jnp.asarray(buf)
    return PointCloud(
        xyz=jnp.asarray(pad_xyz),
        mask=jnp.asarray(mask),
        channels=ch_out,
        frame_id=frame_id,
        timestamp_ns=timestamp_ns,
        nominal_count=n,
        valid_count=int(np.count_nonzero(mask)),
    )


def stage(cloud: PointCloud) -> PointCloud:
    """Start the cloud's H2D transfers asynchronously and return a cloud
    backed by (possibly still in-flight) device arrays.

    Double-buffering hook for interactive streaming: staging scan k+1
    while scan k's integrate runs on device hides the ~12 B/point H2D
    copy behind compute; jax.device_put
    is non-blocking, so this returns immediately."""
    import jax

    return PointCloud(
        xyz=jax.device_put(cloud.xyz),
        mask=jax.device_put(cloud.mask),
        channels={k: jax.device_put(v) for k, v in cloud.channels.items()},
        frame_id=cloud.frame_id,
        timestamp_ns=cloud.timestamp_ns,
        nominal_count=cloud.nominal_count,
        # Carry the host-known valid count: dropping it here would silently
        # disable FastDEM.integrate's auto-bucketing for the documented
        # from_numpy -> stage streaming flow. (Compacting a staged cloud
        # does pay the D2H compact_to_bucket documents — integrate only
        # triggers it when the capacity saving crosses the ladder
        # threshold, where the scatter win dominates the copy.)
        valid_count=cloud.valid_count,
    )


def compact(cloud: PointCloud) -> PointCloud:
    """Host-side: drop masked-out points (exact size, device sync).

    Equivalent of nanoPCL's compacting filter(pred)
    (filters/core.hpp:21-80) when an exact-size result is needed (IO, tests).
    """
    keep = np.asarray(cloud.mask)
    xyz = np.asarray(cloud.xyz)[keep]
    ch = {k: np.asarray(v)[keep] for k, v in cloud.channels.items()}
    return from_numpy(
        xyz, frame_id=cloud.frame_id, timestamp_ns=cloud.timestamp_ns, **ch
    )


def pad_to(cloud: PointCloud, capacity: int) -> PointCloud:
    """Host-side: grow capacity (for bucketed jit shapes)."""
    if capacity == cloud.capacity:
        return cloud
    if capacity < cloud.capacity:
        raise ValueError("pad_to cannot shrink; use compact() first")
    extra = capacity - cloud.capacity
    xyz = jnp.concatenate(
        [cloud.xyz, jnp.full((extra, 3), 1e9, dtype=jnp.float32)], axis=0
    )
    mask = jnp.concatenate([cloud.mask, jnp.zeros(extra, dtype=bool)])
    ch = {
        k: jnp.concatenate(
            [v, jnp.zeros((extra,) + v.shape[1:], dtype=v.dtype)], axis=0
        )
        for k, v in cloud.channels.items()
    }
    return dataclasses.replace(cloud, xyz=xyz, mask=mask, channels=ch)


def extract(cloud: PointCloud, indices) -> PointCloud:
    """Host-side: new cloud with only the given point indices, all channels
    carried (nanoPCL PointCloud::extract, core/point_cloud.hpp:14-184).
    Indices referring to masked-out points are dropped."""
    idx = np.asarray(indices, dtype=np.int64).reshape(-1)
    keep = idx[np.asarray(cloud.mask)[idx]]
    xyz = np.asarray(cloud.xyz)[keep]
    ch = {k: np.asarray(v)[keep] for k, v in cloud.channels.items()}
    return from_numpy(
        xyz, frame_id=cloud.frame_id, timestamp_ns=cloud.timestamp_ns, **ch
    )


def erase(cloud: PointCloud, indices) -> PointCloud:
    """Host-side: new cloud without the given point indices (nanoPCL
    PointCloud::erase); remaining masked-out points are also dropped."""
    drop = np.zeros(cloud.capacity, dtype=bool)
    drop[np.asarray(indices, dtype=np.int64).reshape(-1)] = True
    keep = np.flatnonzero(np.asarray(cloud.mask) & ~drop)
    return extract(cloud, keep)


def bucket_capacity(n: int, granularity: int = 4096) -> int:
    """Round up to a bucket size to bound the number of jit specializations
    for variable-size scans (SURVEY.md section 7 'hard parts')."""
    if n <= 0:
        return granularity
    return ((n + granularity - 1) // granularity) * granularity


def ladder_capacity(n: int, base: int = 4096) -> int:
    """Round up to the geometric capacity ladder base * 2^k.

    Scatter cost is linear in CAPACITY, valid or not (masked rows still
    carry an index into the scatter), so trimming capacity to the valid
    count is the only RGB-D lever — but each capacity is one compiled
    program, so the ladder is geometric: at most log2(N/base) programs
    (~7 for 300K), each within 2x of the true count (average padding
    overhead 1.5x, vs the unbounded linear ladder's compile storm)."""
    if n <= 0:
        return base
    cap = base
    while cap < n:
        cap *= 2
    return cap


def compact_to_bucket(cloud: PointCloud, base: int = 4096) -> PointCloud:
    """Host-side: drop masked-out points and pad to the capacity ladder.

    The auto-bucketing primitive behind FastDEM.integrate:
    an RGB-D frame whose depth image is 60% invalid scatters 300K rows at
    full price unless truly compacted — masking alone saves nothing. Order
    is preserved, so rasterizer tie-breaking (smallest point index among
    packed-quantum z ties) picks the same winning points; decision layers
    (min/max/obstacle/n_points) match the uncompacted integrate exactly,
    estimator layers to ~1 ulp of z-variance (XLA may contract the
    per-point covariance FMAs differently at a different capacity).

    Device-backed clouds pay one D2H here; build clouds with from_numpy
    right before integrate (the streaming shape) to keep this a pure
    host-memory operation.
    """
    keep = np.asarray(cloud.mask)
    xyz = np.asarray(cloud.xyz)[keep]
    ch = {k: np.asarray(v)[keep] for k, v in cloud.channels.items()}
    out = from_numpy(
        xyz,
        frame_id=cloud.frame_id,
        timestamp_ns=cloud.timestamp_ns,
        capacity=ladder_capacity(xyz.shape[0], base),
        **ch,
    )
    # Preserve the pre-compaction emptiness semantics: a nonempty frame
    # whose points were ALL filtered out is still a nonempty frame.
    return dataclasses.replace(out, nominal_count=cloud.nominal_count)


def merge(a: PointCloud, b: PointCloud) -> PointCloud:
    """Concatenate two clouds (nanoPCL operator+=). Channels present in only
    one input are zero-filled in the other."""
    names = set(a.channels) | set(b.channels)
    ch = {}
    for name in names:
        va = a.channels.get(name)
        vb = b.channels.get(name)
        if va is None:
            va = jnp.zeros((a.capacity,) + vb.shape[1:], dtype=vb.dtype)
        if vb is None:
            vb = jnp.zeros((b.capacity,) + va.shape[1:], dtype=va.dtype)
        ch[name] = jnp.concatenate([va, vb], axis=0)
    return PointCloud(
        xyz=jnp.concatenate([a.xyz, b.xyz], axis=0),
        mask=jnp.concatenate([a.mask, b.mask], axis=0),
        channels=ch,
        frame_id=a.frame_id,
        timestamp_ns=a.timestamp_ns,
    )
