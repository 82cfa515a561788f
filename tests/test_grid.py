"""Grid geometry + GridMapState tests (mirrors reference
fastdem/tests/test_elevation_map.cpp: init/geometry, NaN semantics,
accessors; plus move() roll semantics)."""

import jax.numpy as jnp
import numpy as np
import pytest

from fastdem_tpu.grid import gridmap
from fastdem_tpu.grid.geometry import GridGeometry
from fastdem_tpu.grid.gridmap import GridMapState, layers


def make_map(w=15.0, h=15.0, res=0.1, pos=(0.0, 0.0)):
    geom = GridGeometry.from_length(w, h, res)
    state = gridmap.create(geom, gridmap.default_layer_fills(), pos)
    return geom, state


class TestGeometry:
    def test_size(self):
        geom = GridGeometry.from_length(15.0, 15.0, 0.1)
        assert geom.shape == (150, 150)
        assert geom.length == (15.0, 15.0)

    def test_center_cell(self):
        geom, state = make_map()
        # Map center lies at the corner of the 4 middle cells; a point just
        # +x/+y of center maps to the lower-index middle cell.
        r, c, inside = geom.index_of(state.position, jnp.array([0.01, 0.01]))
        assert bool(inside)
        assert (int(r), int(c)) == (74, 74)

    def test_round_trip(self):
        geom, state = make_map()
        rr = np.array([0, 10, 74, 149])
        cc = np.array([0, 5, 75, 149])
        x, y = geom.position_of(state.position, jnp.array(rr), jnp.array(cc))
        r2, c2, inside = geom.index_of(
            state.position, jnp.stack([x, y], axis=-1)
        )
        np.testing.assert_array_equal(np.asarray(r2), rr)
        np.testing.assert_array_equal(np.asarray(c2), cc)
        assert bool(jnp.all(inside))

    def test_row_axis_points_minus_x(self):
        geom, state = make_map()
        x0, _ = geom.position_of(state.position, jnp.array(0), jnp.array(0))
        x1, _ = geom.position_of(state.position, jnp.array(1), jnp.array(0))
        assert float(x0) > float(x1)

    def test_outside(self):
        geom, state = make_map()
        _, _, inside = geom.index_of(state.position, jnp.array([100.0, 0.0]))
        assert not bool(inside)

    def test_cell_id_dummy_slot(self):
        geom, state = make_map()
        ids, inside = geom.cell_id_of(
            state.position, jnp.array([[0.0, 0.0], [99.0, 0.0]])
        )
        assert int(ids[1]) == geom.num_cells
        assert bool(inside[0]) and not bool(inside[1])


class TestGridMapState:
    def test_initial_nan(self):
        _, state = make_map()
        assert bool(jnp.all(jnp.isnan(state.layers[layers.elevation])))

    def test_clear_at_mask(self):
        geom, state = make_map()
        elev = state.layers[layers.elevation].at[3, 4].set(1.5)
        state = state.replace_layer(layers.elevation, elev)
        mask = jnp.zeros(geom.shape, dtype=bool).at[3, 4].set(True)
        state = gridmap.clear_at_mask(state, mask)
        assert bool(jnp.isnan(state.layers[layers.elevation][3, 4]))

    def test_is_finite_mask(self):
        geom, state = make_map()
        elev = state.layers[layers.elevation].at[0, 0].set(2.0)
        state = state.replace_layer(layers.elevation, elev)
        m = gridmap.is_finite_mask(state, layers.elevation)
        assert float(m[0, 0]) == 1.0
        assert float(m[1, 1]) == 0.0

    def test_snapshot_subset(self):
        _, state = make_map()
        snap = gridmap.snapshot(state, [layers.elevation, "missing"])
        assert set(snap.layers) == {layers.elevation}


class TestMove:
    def test_move_preserves_world_content(self):
        geom, state = make_map(w=1.0, h=1.0, res=0.1)
        # Mark the world cell containing (0.05, 0.05) -> index (4, 4).
        r, c, _ = geom.index_of(state.position, jnp.array([0.05, 0.05]))
        elev = state.layers[layers.elevation].at[int(r), int(c)].set(7.0)
        state = state.replace_layer(layers.elevation, elev)

        state = gridmap.move(geom, state, jnp.array([0.2, 0.0]))
        np.testing.assert_allclose(np.asarray(state.position), [0.2, 0.0])
        r2, c2, inside = geom.index_of(state.position, jnp.array([0.05, 0.05]))
        assert bool(inside)
        assert float(state.layers[layers.elevation][int(r2), int(c2)]) == 7.0

    def test_move_invalidates_entered_cells(self):
        geom, state = make_map(w=1.0, h=1.0, res=0.1)
        state = state.replace_layer(
            layers.elevation, jnp.zeros(geom.shape, dtype=jnp.float32)
        )
        state = gridmap.move(geom, state, jnp.array([0.3, 0.0]))
        elev = np.asarray(state.layers[layers.elevation])
        # Moving +x by 3 cells: rows 0..2 are newly-entered -> NaN.
        assert np.all(np.isnan(elev[:3, :]))
        assert np.all(np.isfinite(elev[3:, :]))

    def test_move_snaps_to_lattice(self):
        geom, state = make_map(w=1.0, h=1.0, res=0.1)
        state = gridmap.move(geom, state, jnp.array([0.26, -0.13]))
        np.testing.assert_allclose(
            np.asarray(state.position), [0.3, -0.1], atol=1e-6
        )

    def test_move_half_cell_ties_round_away_from_zero(self):
        """std::round semantics at exact half-cell motion.

        0.05f is exactly 0.1f/2 (same significand, exponent-1), so the
        move quotient is EXACTLY 0.5 — the tie where jnp.round (half-even,
        -> 0) used to diverge from the reference's std::round (half-away,
        -> 1; tests/refbuild/nanogrid/nanogrid.hpp:209-213)."""
        geom, state = make_map(w=1.0, h=1.0, res=0.1)
        state = gridmap.move(geom, state, jnp.array([0.05, -0.05]))
        np.testing.assert_allclose(
            np.asarray(state.position), [0.1, -0.1], atol=1e-7
        )

    def test_round_half_away_matches_std_round(self):
        x = jnp.array(
            [-2.5, -1.5, -0.5, -0.4999, 0.0, 0.4999, 0.5, 1.5, 2.5, 3.0]
        )
        expect = np.array(
            [-3.0, -2.0, -1.0, 0.0, 0.0, 0.0, 1.0, 2.0, 3.0, 3.0]
        )
        np.testing.assert_array_equal(
            np.asarray(gridmap.round_half_away(x)), expect
        )

    def test_move_beyond_extent_clears_all(self):
        geom, state = make_map(w=1.0, h=1.0, res=0.1)
        state = state.replace_layer(
            layers.elevation, jnp.zeros(geom.shape, dtype=jnp.float32)
        )
        state = gridmap.move(geom, state, jnp.array([50.0, 0.0]))
        assert bool(jnp.all(jnp.isnan(state.layers[layers.elevation])))


class TestSubmap:
    def test_submap_slices(self):
        geom, state = make_map()
        rs, cs = gridmap.submap_slices(
            geom, np.array([0.0, 0.0]), (0.0, 0.0), (3.0, 3.0)
        )
        assert rs.stop - rs.start == 30
        assert cs.stop - cs.start == 30

    def test_submap_clipped(self):
        geom, state = make_map()
        rs, cs = gridmap.submap_slices(
            geom, np.array([0.0, 0.0]), (7.0, 7.0), (3.0, 3.0)
        )
        assert rs.start == 0
