"""Program-structure regression net for the hot path.

The headline config's irregular ops are: ONE row scatter (all
rasterizer lanes), ONE flat polar-slope scatter, ONE gather for the
argmin variance, and ONE gather for the polar field resample. These tests
lower the integrate step to StableHLO and count the ops, so a change that
silently reintroduces extra scatters/gathers fails loudly instead of
surfacing as a benchmark regression later. Counts are
platform-independent (pre-optimization HLO).
"""

import re

import jax
import jax.numpy as jnp

from fastdem_tpu import Config, GridGeometry
from fastdem_tpu.config.config import MappingMode
from fastdem_tpu.mapping.pipeline import build_integrate, create_map_state


def _op_counts(cfg, geom, n=30_000):
    step = build_integrate(geom, cfg, jit=False)
    state = create_map_state(geom, cfg)
    xyz = jnp.zeros((n, 3))
    mask = jnp.ones(n, bool)
    T = jnp.eye(4)
    txt = jax.jit(step).lower(state, xyz, mask, T, T).as_text()
    return {
        op: len(re.findall(rf'= "stablehlo\.{op}"', txt))
        + len(re.findall(rf"= stablehlo\.{op}\b", txt))
        for op in ("scatter", "gather", "sort", "while")
    }


def test_headline_irregular_op_budget():
    cfg = Config()
    cfg.raycasting.enabled = True
    geom = GridGeometry.from_length(15.0, 15.0, 0.1)
    c = _op_counts(cfg, geom)
    # 1 row scatter + 1 polar scatter; 1 var gather + 1 rider
    # gather. No sorts, no data-dependent loops.
    assert c["scatter"] == 2, c
    assert c["gather"] == 2, c
    assert c["sort"] == 0, c
    assert c["while"] == 0, c


def test_no_raycast_irregular_op_budget():
    cfg = Config()
    cfg.raycasting.enabled = False
    geom = GridGeometry.from_length(15.0, 15.0, 0.1)
    c = _op_counts(cfg, geom)
    # 1 row scatter; 1 var gather.
    assert c["scatter"] == 1, c
    assert c["gather"] == 1, c


def test_windowed_global_irregular_op_budget():
    """The windowed GLOBAL path must not add irregular ops beyond the
    headline set (the window only re-bases ids and adds dense
    slice/write-back): 2 scatters + the per-point path's extra argmin
    scatter, and gathers for amin@pt + rider."""
    cfg = Config()
    cfg.raycasting.enabled = True
    cfg.mapping.mode = MappingMode.GLOBAL
    cfg.point_filter.range_max = 20.0
    geom = GridGeometry.from_length(200.0, 200.0, 0.1)
    c = _op_counts(cfg, geom)
    assert c["scatter"] == 3, c  # row + polar + per-point argmin write
    assert c["gather"] == 2, c  # amin@pt + rider
    assert c["sort"] == 0, c
