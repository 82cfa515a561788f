"""Dense branchless P^2 online-quantile estimator (Jain & Chlamtac 1985).

Vectorized equivalent of the reference per-cell implementation
(/root/reference/fastdem/include/fastdem/mapping/quantile_estimation.hpp:141-258):
the 5-way interval select, marker adjustment with parabolic/linear
interpolation, phase-1 insertion + sort, and fading memory are all expressed
as masked elementwise ops over the whole grid — no data-dependent control
flow, so the per-scan update compiles to a handful of fused elementwise passes.

Recurrence parity notes (file:line refer to quantile_estimation.hpp):
  * phase 1 (count < 5): q[count] = x; on reaching 5, sort q and set
    n = [0..4]  (:185-194)
  * phase 2 interval: k from strict comparisons, with extreme-marker
    clamping q0 = min(q0, x), q4 = max(q4, x)  (:197-212)
  * n[i] += 1 for i > k; n' = dn * count (pre-increment)  (:214-219)
  * fading memory rescale when count exceeds max_sample_count  (:222-226)
  * interior markers i = 1..3 updated SEQUENTIALLY (n[i-1] may have been
    changed at i-1), parabolic with linear fallback  (:229-239)
  * elevation = q[elevation_marker] if count >= 5 else x  (:161-162)
  * compute_bounds: elevation = q[m]; sigma = (q3 - q1)/2; variance = sigma^2;
    lower = q0, upper = q4  (:166-178)
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from fastdem_tpu.config.config import P2Config
from fastdem_tpu.grid.gridmap import GridMapState, layers


def layer_fills() -> Dict[str, float]:
    """Initial fills (quantile_estimation.hpp:97-115)."""
    fills: Dict[str, float] = {
        layers.variance: np.nan,
        layers.n_points: 0.0,
        layers.upper_bound: np.nan,
        layers.lower_bound: np.nan,
    }
    for i, name in enumerate(layers.p2_q):
        fills[name] = np.nan
    for i, name in enumerate(layers.p2_n):
        fills[name] = float(i)
    return fills


def _marker_deltas(cfg: P2Config) -> Tuple[float, ...]:
    """Clamped, monotonic dn as enforced by the ctor (:83-94)."""
    dn = [
        min(max(v, 0.0), 1.0)
        for v in (cfg.dn0, cfg.dn1, cfg.dn2, cfg.dn3, cfg.dn4)
    ]
    for i in range(1, 5):
        dn[i] = max(dn[i], dn[i - 1])
    return tuple(dn)


def _update_p2(
    q: jnp.ndarray, n: jnp.ndarray, count: jnp.ndarray, x: jnp.ndarray,
    cfg: P2Config,
):
    """Core P^2 step on stacked markers q, n: f32[5, H, W]."""
    dn = _marker_deltas(cfg)
    count0 = jnp.where(jnp.isnan(count) | (count < 0.0), 0.0, count)
    phase1 = count0 < 5.0

    # ---- Phase 1: insert x at slot count0, sort on reaching 5 ----
    slot = jnp.floor(count0).astype(jnp.int32)
    sel = jnp.arange(5, dtype=jnp.int32)[:, None, None] == slot[None]
    q_p1 = jnp.where(sel, x[None], q)
    count_p1 = count0 + 1.0
    reached5 = count_p1 >= 5.0
    q_sorted = jnp.sort(q_p1, axis=0)
    q_p1 = jnp.where(reached5[None], q_sorted, q_p1)
    n_init = jnp.arange(5, dtype=jnp.float32)[:, None, None]
    n_p1 = jnp.where(reached5[None], jnp.broadcast_to(n_init, n.shape), n)

    # ---- Phase 2 ----
    k = (
        (x >= q[1]).astype(jnp.int32)
        + (x >= q[2]).astype(jnp.int32)
        + (x >= q[3]).astype(jnp.int32)
    )
    q2 = q.at[0].set(jnp.where(x < q[0], x, q[0]))
    q2 = q2.at[4].set(jnp.where(x > q[4], x, q[4]))
    marker_gt_k = jnp.arange(5, dtype=jnp.int32)[:, None, None] > k[None]
    n2 = n + marker_gt_k.astype(jnp.float32)
    n_prime = jnp.stack([d * count0 for d in dn])
    count_p2 = count0 + 1.0

    if cfg.max_sample_count > 0.0:
        over = count_p2 > cfg.max_sample_count
        scale = jnp.where(over, cfg.max_sample_count / count_p2, 1.0)
        n2 = n2 * scale[None]
        count_p2 = jnp.where(over, cfg.max_sample_count, count_p2)

    # Interior markers, sequential in i (n2[i-1] may change at step i-1).
    qs = [q2[i] for i in range(5)]
    ns = [n2[i] for i in range(5)]
    for i in (1, 2, 3):
        d = n_prime[i] - ns[i]
        cond = ((d >= 1.0) & (ns[i + 1] - ns[i] > 1.0)) | (
            (d <= -1.0) & (ns[i - 1] - ns[i] < -1.0)
        )
        sign = jnp.where(d >= 0.0, 1.0, -1.0)

        # parabolic (:242-251) with zero-denominator guard
        d_right = ns[i + 1] - ns[i]
        d_left = ns[i] - ns[i - 1]
        d_span = ns[i + 1] - ns[i - 1]
        degen = (d_right == 0.0) | (d_left == 0.0) | (d_span == 0.0)
        sr = jnp.where(d_right == 0.0, 1.0, d_right)
        sl = jnp.where(d_left == 0.0, 1.0, d_left)
        ss = jnp.where(d_span == 0.0, 1.0, d_span)
        t1 = (d_left + sign) * (qs[i + 1] - qs[i]) / sr
        t2 = (d_right - sign) * (qs[i] - qs[i - 1]) / sl
        q_par = jnp.where(degen, qs[i], qs[i] + sign * (t1 + t2) / ss)

        # linear (:253-258): neighbor j = i + sign
        q_j = jnp.where(sign > 0, qs[i + 1], qs[i - 1])
        n_j = jnp.where(sign > 0, ns[i + 1], ns[i - 1])
        dn_j = n_j - ns[i]
        q_lin = jnp.where(
            dn_j == 0.0,
            qs[i],
            qs[i] + sign * (q_j - qs[i]) / jnp.where(dn_j == 0.0, 1.0, dn_j),
        )

        q_new = jnp.where(
            (qs[i - 1] < q_par) & (q_par < qs[i + 1]), q_par, q_lin
        )
        qs[i] = jnp.where(cond, q_new, qs[i])
        ns[i] = jnp.where(cond, ns[i] + sign, ns[i])

    q_p2 = jnp.stack(qs)
    n_p2 = jnp.stack(ns)

    # ---- Combine phases ----
    q_out = jnp.where(phase1[None], q_p1, q_p2)
    n_out = jnp.where(phase1[None], n_p1, n_p2)
    count_out = jnp.where(phase1, count_p1, count_p2)
    return q_out, n_out, count_out


def _stack(state: GridMapState, names) -> jnp.ndarray:
    return jnp.stack([state.layers[n] for n in names])


def update(
    state: GridMapState,
    cfg: P2Config,
    z: jnp.ndarray,
    z_var: jnp.ndarray,  # unused, parity with Kalman signature
    touched: jnp.ndarray,
) -> GridMapState:
    """One scan's P^2 update (quantile_estimation.hpp:141-163)."""
    del z_var
    q = _stack(state, layers.p2_q)
    n = _stack(state, layers.p2_n)
    count = state.layers[layers.n_points]

    q_new, n_new, count_new = _update_p2(q, n, count, z, cfg)

    elev_idx = min(max(cfg.elevation_marker, 0), 4)
    elev_new = jnp.where(count_new >= 5.0, q_new[elev_idx], z)

    upd = {layers.n_points: jnp.where(touched, count_new, count)}
    for i, name in enumerate(layers.p2_q):
        upd[name] = jnp.where(touched, q_new[i], q[i])
    for i, name in enumerate(layers.p2_n):
        upd[name] = jnp.where(touched, n_new[i], n[i])
    upd[layers.elevation] = jnp.where(
        touched, elev_new, state.layers[layers.elevation]
    )
    return state.replace_layers(upd)


def compute_bounds(
    state: GridMapState, cfg: P2Config, touched: jnp.ndarray
) -> GridMapState:
    """Per-cell bounds/variance refresh (quantile_estimation.hpp:166-178).
    NOTE: also overwrites elevation with q[marker] — matching the reference
    pipeline, where estimate() runs update + computeBounds per touched cell
    (src/elevation_mapping.cpp:98-107)."""
    elev_idx = min(max(cfg.elevation_marker, 0), 4)
    q = _stack(state, layers.p2_q)
    sigma = (q[3] - q[1]) / 2.0

    def sel(new, name):
        return jnp.where(touched, new, state.layers[name])

    return state.replace_layers(
        {
            layers.elevation: sel(q[elev_idx], layers.elevation),
            layers.variance: sel(sigma * sigma, layers.variance),
            layers.lower_bound: sel(q[0], layers.lower_bound),
            layers.upper_bound: sel(q[4], layers.upper_bound),
        }
    )


def estimate(
    state: GridMapState,
    cfg: P2Config,
    z: jnp.ndarray,
    z_var: jnp.ndarray,
    touched: jnp.ndarray,
) -> GridMapState:
    """update + compute_bounds, the per-scan pipeline behavior."""
    state = update(state, cfg, z, z_var, touched)
    return compute_bounds(state, cfg, touched)
