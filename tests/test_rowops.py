"""The raycaster's dense polar field and its per-cell lookups against
independent NumPy oracles, and the rasterizer's bit-exact gather helper.

The polar field (postprocess/raycasting.polar_smeared_field) is XLA's own
fusion of ~30 dense passes; here a plain loop recomputes it from its
definition: reverse cumulative min along range, in-cell range fold, and
the min over each range column's azimuth window.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from fastdem_tpu.grid.geometry import GridGeometry
from fastdem_tpu.mapping.rasterize import _gather_bits
from fastdem_tpu.postprocess.raycasting import (
    AZ_HALF_WIDTH,
    polar_dims,
    polar_resample,
    polar_smeared_field,
    resample_indices,
)

GEOM = GridGeometry.from_length(15.0, 15.0, 0.1)
SO = np.asarray([0.07, -0.03, 1.2], dtype=np.float32)


def slope_table(rng, R, A, specials=False):
    tbl = rng.uniform(-2.0, 0.5, R * A).astype(np.float32)
    tbl[rng.random(R * A) < 0.97] = np.inf
    if specials:
        tbl[rng.integers(0, R * A, 40)] = np.nan
        tbl[rng.integers(0, R * A, 40)] = -np.inf
    return tbl


def oracle_field(tbl, A, rbf, max_range, exact):
    """Loop oracle of polar_smeared_field (float32 arithmetic)."""
    _, R, dr = polar_dims(GEOM, A, rbf, max_range)
    scat = tbl.reshape(R, A)
    # 1. Reverse cumulative min along range: min slope of rays alive at r.
    ms = np.full((R, A), np.inf, np.float32)
    run = np.full(A, np.inf, np.float32)
    for r in range(R - 1, -1, -1):
        run = np.where(np.isnan(scat[r]) | np.isnan(run), np.nan,
                       np.minimum(run, scat[r]))
        ms[r] = run
    d_r = np.arange(R, dtype=np.float32)[:, None] * np.float32(dr)
    with np.errstate(invalid="ignore"):
        h = np.where(np.isfinite(ms), SO[2] + ms * d_r, np.inf)
    h = h.astype(np.float32)
    # 2. In-cell fold: min over the nfold range bins ending at r.
    nfold = max(1, int(math.ceil(1.0 / rbf)))
    fold = np.full_like(h, np.inf)
    for r in range(R):
        for j in range(nfold):
            fold[r] = np.minimum(fold[r], h[max(r - j, 0)])
    # 3. Azimuth window per range column, starting at bin a.
    out = np.empty_like(fold)
    for r in range(R):
        d = np.float32(r) * np.float32(dr)
        half_w = np.arctan2(
            np.float32(GEOM.resolution * AZ_HALF_WIDTH),
            np.maximum(d, np.float32(1e-6)),
        )
        w = int(np.clip(np.ceil(half_w / (2 * np.pi / A) * 2.0) + 1,
                        1, A // 2))
        win = w if exact else 1 << int(math.floor(math.log2(w)))
        acc = fold[r].copy()
        for k in range(1, win):
            acc = np.minimum(acc, np.roll(fold[r], -k))
        out[r] = acc
    return out


CASES = [
    (2048, 0.25, 12.81, True),
    (1024, 0.5, 9.0, True),
    (2048, 0.25, 12.81, False),
    (100, 0.5, None, True),  # azimuth count no multiple of 128
]


@pytest.mark.parametrize("num_az,rbf,maxr,exact", CASES)
def test_polar_field_matches_loop_oracle(rng, num_az, rbf, maxr, exact):
    """Identical finite sets; heights to f32 FMA-contraction tolerance
    (h = z0 + slope * d may or may not contract)."""
    A, R, _ = polar_dims(GEOM, num_az, rbf, maxr)
    tbl = slope_table(rng, R, A)
    got = np.asarray(
        polar_smeared_field(
            GEOM, jnp.asarray(SO), jnp.asarray(tbl), num_az, rbf, maxr,
            exact_window=exact,
        )
    )
    want = oracle_field(tbl, num_az, rbf, maxr, exact)
    assert got.shape == (R, A)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=4e-6)


@pytest.mark.parametrize(
    "num_az,exact,specials",
    [(1000, True, False), (100, False, True), (2048, True, True),
     (2048, False, False)],
)
def test_cell_lookup_matches_fancy_indexing(rng, num_az, exact, specials):
    """polar_resample's per-cell lookup (plain gathers) == NumPy fancy
    indexing of the same field, bit for bit, incl. NaN/-inf slopes in the
    table and fields whose size is no multiple of 128."""
    rbf, maxr = 0.5, 9.0
    A, R, _ = polar_dims(GEOM, num_az, rbf, maxr)
    tbl = slope_table(rng, R, A, specials)
    pos = jnp.asarray([0.3, -0.2], jnp.float32)
    h, touched = polar_resample(
        GEOM, pos, jnp.asarray(SO), jnp.asarray(tbl), num_az, rbf, maxr,
        exact_window=exact,
    )
    field = np.asarray(
        polar_smeared_field(GEOM, jnp.asarray(SO), jnp.asarray(tbl),
                            num_az, rbf, maxr, exact_window=exact)
    )
    a0, a1, r_idx, in_range = (
        np.asarray(v) for v in resample_indices(
            GEOM, pos, jnp.asarray(SO), num_az, rbf, maxr
        )
    )
    want = field[r_idx, a0]
    if not exact:
        want = np.minimum(want, field[r_idx, a1])
    want_touched = np.isfinite(want) & in_range
    np.testing.assert_array_equal(np.asarray(touched), want_touched)
    np.testing.assert_array_equal(
        np.asarray(h), np.where(want_touched, want, np.nan)
    )
    assert want_touched.any()


@pytest.mark.parametrize(
    "buf",
    [
        np.asarray([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, 3.5],
                   np.float32),
        np.random.default_rng(7).integers(
            -(2**31), 2**31 - 1, 131
        ).astype(np.int32),
    ],
    ids=["f32_specials", "int32_bits_131"],
)
def test_gather_bits_exact(rng, buf):
    """Every payload bit pattern survives (NaN, +-inf, -0.0, denormals,
    arbitrary int32 bits); idx shape is preserved."""
    idx = rng.integers(0, buf.shape[0], (6, 9)).astype(np.int32)
    out = np.asarray(_gather_bits(jnp.asarray(buf), jnp.asarray(idx)))
    assert out.shape == idx.shape and out.dtype == buf.dtype
    np.testing.assert_array_equal(
        out.view(np.int32), buf[idx].view(np.int32)
    )
