"""Multi-chip sharding tests on the 8-device virtual CPU mesh: block-sharded
global map integrate + stencil postprocess, numerical parity with the
single-device path, and the driver dryrun hook."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastdem_tpu.config.config import Config, MappingMode
from fastdem_tpu.grid.geometry import GridGeometry
from fastdem_tpu.grid.gridmap import layers
from fastdem_tpu.mapping.pipeline import build_integrate, create_map_state
from fastdem_tpu.parallel import sharding as sh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scan(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(0.5, 6.0, n)
    xyz = np.column_stack(
        [rad * np.cos(ang), rad * np.sin(ang), rng.normal(-1.0, 0.05, n)]
    ).astype(np.float32)
    return jnp.asarray(xyz), jnp.ones(n, dtype=bool)


I4 = jnp.eye(4)


@pytest.fixture(scope="module")
def geom_cfg():
    geom = GridGeometry.from_length(16.0, 16.0, 0.25)  # 64x64
    cfg = Config()
    cfg.mapping.mode = MappingMode.GLOBAL
    cfg.raycasting.enabled = True
    return geom, cfg


class TestMesh:
    def test_mesh_shape(self):
        mesh = sh.make_mesh(8)
        assert mesh.devices.size == 8
        assert mesh.axis_names == ("mx", "my")

    def test_mesh_squarish(self):
        assert sh.make_mesh(8).shape == {"mx": 4, "my": 2}


class TestShardedIntegrate:
    def test_parity_with_single_device(self, geom_cfg):
        geom, cfg = geom_cfg
        xyz, mask = scan()
        T_bs = I4
        T_wb = I4

        # Single-device reference run.
        step1 = build_integrate(geom, cfg, jit=True, donate=False)
        s1 = create_map_state(geom, cfg)
        s1, _ = step1(s1, xyz, mask, T_bs, T_wb)
        s1, _ = step1(s1, xyz, mask, T_bs, T_wb)

        # 8-device sharded run.
        mesh = sh.make_mesh(8)
        stepN, shard = sh.build_sharded_integrate(geom, cfg, mesh, donate=False)
        sN = shard(create_map_state(geom, cfg))
        sN, _ = stepN(sN, xyz, mask, T_bs, T_wb)
        sN, _ = stepN(sN, xyz, mask, T_bs, T_wb)

        for name in (
            layers.elevation,
            layers.variance,
            layers.n_points,
            layers.elevation_max,
            layers.visibility_logodds,
        ):
            np.testing.assert_allclose(
                np.asarray(s1.layers[name]),
                np.asarray(sN.layers[name]),
                rtol=1e-5,
                atol=1e-6,
                err_msg=name,
            )

    def test_parity_large_map_per_point_path(self):
        """Large map (ncell > 2n) exercises the rasterizer's PER-POINT
        argmin realization, whose fused gather must run in int32:
        GSPMD partitions gathers with zero-fill + f32 SUM combining, which
        flushes denormal bit patterns (bitcast argmin indices, packed
        colors) to zero — regression for the bug where a sharded global
        map with raycasting came out empty. Colors ride along so the
        packed-denormal lane is covered too."""
        from fastdem_tpu.utils.colors import pack_rgb

        geom = GridGeometry.from_length(40.0, 40.0, 0.2)  # 200x200 = 40K
        cfg = Config()
        cfg.mapping.mode = MappingMode.GLOBAL
        cfg.raycasting.enabled = True
        cfg.point_filter.range_max = 20.0
        rng = np.random.default_rng(3)
        n = 4096  # ncell = 40000 > 2n -> per-point path
        ang = rng.uniform(0, 2 * np.pi, n)
        rad = rng.uniform(0.5, 18.0, n)
        xyz = jnp.asarray(
            np.column_stack(
                [rad * np.cos(ang), rad * np.sin(ang), 0.2 * np.sin(rad) - 1.0]
            ).astype(np.float32)
        )
        mask = jnp.ones(n, dtype=bool)
        # Low-byte-only colors bitcast to denormal f32 patterns (raw u8
        # values — pack_rgb casts to uint32, so a /255.0 normalization
        # would truncate every channel to 0 and never exercise the
        # denormal bits this test exists to pin).
        color = pack_rgb(
            jnp.asarray(
                np.column_stack(
                    [np.zeros(n), np.zeros(n), rng.integers(1, 255, n)]
                ).astype(np.float32)
            )
        )
        T_bs = I4.at[2, 3].set(1.0)

        step1 = build_integrate(geom, cfg, has_color=True, donate=False)
        s1 = create_map_state(geom, cfg, has_color=True)
        mesh = sh.make_mesh(8)
        stepN, shard = sh.build_sharded_integrate(
            geom, cfg, mesh, has_color=True, donate=False
        )
        sN = shard(create_map_state(geom, cfg, has_color=True))
        for _ in range(2):
            s1, _ = step1(s1, xyz, mask, T_bs, I4, None, color)
            sN, _ = stepN(sN, xyz, mask, T_bs, I4, None, color)

        assert np.isfinite(
            np.asarray(sN.layers[layers.elevation])
        ).sum() == np.isfinite(np.asarray(s1.layers[layers.elevation])).sum()
        for name in s1.layers:
            a = np.asarray(s1.layers[name])
            b = np.asarray(sN.layers[name])
            np.testing.assert_array_equal(
                np.isnan(a), np.isnan(b), err_msg=name
            )
            both = np.isfinite(a) & np.isfinite(b)
            np.testing.assert_allclose(
                a[both], b[both], rtol=1e-5, atol=1e-6, err_msg=name
            )

    def test_layers_actually_sharded(self, geom_cfg):
        geom, cfg = geom_cfg
        mesh = sh.make_mesh(8)
        _, shard = sh.build_sharded_integrate(geom, cfg, mesh, donate=False)
        s = shard(create_map_state(geom, cfg))
        sharding = s.layers[layers.elevation].sharding
        assert sharding.is_fully_replicated is False


class TestShardedSequence:
    def test_sharded_replay_matches_single_device(self):
        """Batched replay (lax.scan over K scans) over a block-sharded
        global map == the single-device sequence, decision layers exact."""
        from fastdem_tpu.mapping.pipeline import build_integrate_sequence

        geom = GridGeometry.from_length(40.0, 40.0, 0.2)
        cfg = Config()
        cfg.mapping.mode = MappingMode.GLOBAL
        cfg.raycasting.enabled = True
        cfg.point_filter.range_max = 20.0
        rng = np.random.default_rng(5)
        K, n = 4, 4096
        ang = rng.uniform(0, 2 * np.pi, (K, n))
        rad = rng.uniform(0.5, 18.0, (K, n))
        xyz = jnp.asarray(
            np.stack(
                [rad * np.cos(ang), rad * np.sin(ang), 0.2 * np.sin(rad) - 1.0],
                -1,
            ).astype(np.float32)
        )
        mask = jnp.ones((K, n), bool)
        poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        poses[:, 0, 3] = 0.5 * np.arange(K)
        T_bs = I4.at[2, 3].set(1.0)

        seq1 = build_integrate_sequence(geom, cfg, donate=False)
        s1 = seq1(
            create_map_state(geom, cfg), xyz, mask, T_bs, jnp.asarray(poses)
        )

        mesh = sh.make_mesh(8)
        seqN, shard = sh.build_sharded_integrate_sequence(
            geom, cfg, mesh, donate=False
        )
        sN = seqN(
            shard(create_map_state(geom, cfg)), xyz, mask, T_bs,
            jnp.asarray(poses),
        )
        assert sN.layers[layers.elevation].sharding.is_fully_replicated is False
        for name in s1.layers:
            a = np.asarray(s1.layers[name])
            b = np.asarray(sN.layers[name])
            if name in (layers.raycasting, layers.visibility_logodds):
                # Discrete-bin layers: XLA contracts FMAs differently in
                # the sharded compilation, so a 1-ULP geometry difference
                # can flip a polar/z bin — tolerate isolated flips bounded
                # by one evidence quantum (observed: 5 cells of 10.9K).
                assert (np.isnan(a) != np.isnan(b)).sum() <= a.size // 1000
                both = np.isfinite(a) & np.isfinite(b)
                bad = np.abs(a[both] - b[both]) > 1e-6
                assert bad.sum() <= max(8, a.size // 1000), name
                if both.any():
                    assert np.abs(a[both] - b[both]).max() <= 0.21, name
                continue
            np.testing.assert_array_equal(
                np.isnan(a), np.isnan(b), err_msg=name
            )
            both = np.isfinite(a) & np.isfinite(b)
            np.testing.assert_allclose(
                a[both], b[both], rtol=1e-5, atol=1e-6, err_msg=name
            )


class TestShardedLocalMode:
    def test_local_move_parity_under_gspmd(self):
        """LOCAL mode under block sharding: gridmap.move's roll +
        mask-clear becomes a collective permute per scan. Poses advance a full cell+ per scan so the roll is
        exercised across block boundaries; every layer must match the
        single-device run."""
        geom = GridGeometry.from_length(16.0, 16.0, 0.25)  # 64x64
        cfg = Config()
        cfg.mapping.mode = MappingMode.LOCAL
        cfg.raycasting.enabled = True
        xyz, mask = scan()
        T_bs = I4.at[2, 3].set(1.0)
        poses = []
        for k in range(4):
            p = np.eye(4, dtype=np.float32)
            p[0, 3] = 0.8 * k  # +3.2 cells/scan along x
            p[1, 3] = -0.3 * k
            poses.append(jnp.asarray(p))

        step1 = build_integrate(geom, cfg, donate=False)
        s1 = create_map_state(geom, cfg)
        mesh = sh.make_mesh(8)
        stepN, shard = sh.build_sharded_integrate(geom, cfg, mesh, donate=False)
        sN = shard(create_map_state(geom, cfg))
        for T_wb in poses:
            s1, _ = step1(s1, xyz, mask, T_bs, T_wb)
            sN, _ = stepN(sN, xyz, mask, T_bs, T_wb)

        np.testing.assert_allclose(
            np.asarray(s1.position), np.asarray(sN.position)
        )
        assert sN.layers[layers.elevation].sharding.is_fully_replicated is False
        for name in s1.layers:
            a = np.asarray(s1.layers[name])
            b = np.asarray(sN.layers[name])
            if name in (layers.raycasting, layers.visibility_logodds):
                # Discrete polar/z bins may flip on 1-ULP geometry
                # differences between the two compilations (same envelope
                # as the replay test above).
                assert (np.isnan(a) != np.isnan(b)).sum() <= max(
                    8, a.size // 1000
                ), name
                both = np.isfinite(a) & np.isfinite(b)
                bad = np.abs(a[both] - b[both]) > 1e-6
                assert bad.sum() <= max(8, a.size // 1000), name
                continue
            np.testing.assert_array_equal(
                np.isnan(a), np.isnan(b), err_msg=name
            )
            both = np.isfinite(a) & np.isfinite(b)
            np.testing.assert_allclose(
                a[both], b[both], rtol=1e-5, atol=1e-6, err_msg=name
            )


class TestShardedPostprocess:
    def test_stencil_parity_with_single_device(self):
        """The snapshot postprocess chain (UF + inpaint + features) is all
        neighborhood stencils; under block sharding GSPMD must insert halo
        exchanges at every block edge. Parity vs the unsharded run over a
        map with NaN holes spanning block boundaries."""
        from fastdem_tpu.config.config import PostProcessConfig
        from fastdem_tpu.postprocess import apply_postprocess_fn

        geom = GridGeometry.from_length(16.0, 16.0, 0.25)  # 64x64
        pp = PostProcessConfig()
        pp.uncertainty_fusion.enabled = True
        pp.inpainting.enabled = True
        pp.feature_extraction.enabled = True
        fn = apply_postprocess_fn(geom, pp)

        rng = np.random.default_rng(7)
        elev = rng.normal(-1.0, 0.2, geom.shape).astype(np.float32)
        holes = rng.uniform(size=geom.shape) < 0.15
        elev[holes] = np.nan
        upper = elev + 0.2
        lower = elev - 0.2

        out1 = jax.jit(fn)(elev, upper, lower)

        mesh = sh.make_mesh(8)
        lyr_sh = sh.map_sharding(mesh)
        args_sh = tuple(jax.device_put(a, lyr_sh) for a in (elev, upper, lower))
        outN = jax.jit(fn, in_shardings=(lyr_sh,) * 3)(*args_sh)

        assert set(out1) == set(outN)
        for name in out1:
            a = np.asarray(out1[name])
            b = np.asarray(outN[name])
            np.testing.assert_array_equal(
                np.isnan(a), np.isnan(b), err_msg=name
            )
            both = np.isfinite(a) & np.isfinite(b)
            np.testing.assert_allclose(
                a[both], b[both], rtol=1e-5, atol=1e-5, err_msg=name
            )


class TestDryrun:
    def test_dryrun_multichip(self):
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)

    def test_entry_compiles(self):
        import __graft_entry__ as ge

        fn, args = ge.entry()
        state, aux = jax.jit(fn)(*args)
        jax.block_until_ready(state.layers)
        elev = np.asarray(state.layers[layers.elevation])
        assert np.isfinite(elev).sum() > 0


class TestDistributed:
    def test_scaling_report_runs(self):
        from fastdem_tpu.config.config import Config, MappingMode
        from fastdem_tpu.parallel.distributed import scaling_report

        geom = GridGeometry.from_length(12.8, 12.8, 0.2)
        cfg = Config()
        cfg.mapping.mode = MappingMode.GLOBAL
        rep = scaling_report(geom, cfg, scans=3, points=2048)
        assert rep["devices"] == 8
        assert rep["ms_single"] > 0 and rep["ms_sharded"] > 0

    def test_sharded_checkpoint(self, tmp_path):
        import jax

        from fastdem_tpu.config.config import Config, MappingMode
        from fastdem_tpu.io.npz import load_npz
        from fastdem_tpu.mapping.pipeline import create_map_state
        from fastdem_tpu.parallel import sharding as sh
        from fastdem_tpu.parallel.distributed import save_sharded_npz

        geom = GridGeometry.from_length(16.0, 16.0, 0.5)
        cfg = Config()
        cfg.mapping.mode = MappingMode.GLOBAL
        mesh = sh.make_mesh(8)
        state = sh.shard_state(create_map_state(geom, cfg), mesh)
        state = state.replace_layer(
            layers.elevation,
            jax.device_put(
                jnp.arange(geom.num_cells, dtype=jnp.float32).reshape(
                    geom.shape
                ),
                sh.map_sharding(mesh),
            ),
        )
        path = str(tmp_path / "sharded.npz")
        assert save_sharded_npz(path, geom, state)
        geom2, state2, _ = load_npz(path)
        assert geom2 == geom
        np.testing.assert_array_equal(
            np.asarray(state2.layers[layers.elevation]),
            np.asarray(state.layers[layers.elevation]),
        )

    def test_sharded_checkpoint_streams_blocks(self, tmp_path):
        """The streaming writer (col_block smaller than the map) must emit
        byte-identical npz to the assemble-on-host writer."""
        import jax

        from fastdem_tpu.config.config import Config, MappingMode
        from fastdem_tpu.io.npz import save_npz
        from fastdem_tpu.mapping.pipeline import create_map_state
        from fastdem_tpu.parallel import sharding as sh
        from fastdem_tpu.parallel.distributed import save_sharded_npz

        geom = GridGeometry.from_length(16.0, 16.0, 0.5)  # 32x32
        cfg = Config()
        cfg.mapping.mode = MappingMode.GLOBAL
        mesh = sh.make_mesh(8)
        rng = np.random.default_rng(11)
        state = create_map_state(geom, cfg)
        state = state.replace_layer(
            layers.elevation,
            jnp.asarray(rng.normal(size=geom.shape).astype(np.float32)),
        )
        sharded = sh.shard_state(state, mesh)
        p_stream = str(tmp_path / "stream.npz")
        p_host = str(tmp_path / "host.npz")
        # 5 columns per block: forces 7 blocks incl. a ragged tail.
        assert save_sharded_npz(p_stream, geom, sharded, col_block=5)
        host_state = jax.tree.map(lambda a: np.asarray(a), state)
        assert save_npz(p_host, geom, host_state)
        assert open(p_stream, "rb").read() == open(p_host, "rb").read()


class TestProfiling:
    def test_stats_iqr(self):
        from fastdem_tpu.utils.profiling import compute_stats

        s = compute_stats([1.0, 1.1, 0.9, 1.05, 50.0])
        assert s.n_outliers == 1
        assert 0.9 <= s.mean <= 1.2

    def test_benchmark_helper(self):
        import jax.numpy as jnp

        from fastdem_tpu.utils.profiling import benchmark, platform_info

        x = jnp.zeros((64, 64))
        st = benchmark(lambda: x + 1, warmup=1, reps=5)
        assert st.mean >= 0
        assert "device" in platform_info()


class TestOrbaxCheckpoint:
    def test_sharded_save_restore(self, tmp_path):
        from fastdem_tpu.config.config import Config, MappingMode
        from fastdem_tpu.io.orbax_ckpt import load_orbax, save_orbax
        from fastdem_tpu.mapping.pipeline import create_map_state
        from fastdem_tpu.parallel import sharding as sh

        geom = GridGeometry.from_length(16.0, 16.0, 0.5)
        cfg = Config()
        cfg.mapping.mode = MappingMode.GLOBAL
        mesh = sh.make_mesh(8)
        state = sh.shard_state(create_map_state(geom, cfg), mesh)
        state = state.replace_layer(
            layers.elevation,
            jnp.zeros(geom.shape).at[3, 4].set(1.25),
        )
        path = str(tmp_path / "ckpt")
        save_orbax(path, geom, state)

        geom2, state2, meta = load_orbax(path, sharding=sh.map_sharding(mesh))
        assert geom2 == geom
        assert not state2.layers[layers.elevation].sharding.is_fully_replicated
        np.testing.assert_allclose(
            np.asarray(state2.layers[layers.elevation]),
            np.asarray(state.layers[layers.elevation]),
        )

    def test_unsharded_restore(self, tmp_path):
        from fastdem_tpu.config.config import Config
        from fastdem_tpu.io.orbax_ckpt import load_orbax, save_orbax
        from fastdem_tpu.mapping.pipeline import create_map_state

        geom = GridGeometry.from_length(4.0, 4.0, 0.5)
        state = create_map_state(geom, Config())
        path = str(tmp_path / "c2")
        save_orbax(path, geom, state)
        geom2, state2, _ = load_orbax(path)
        assert set(state2.layers) == set(state.layers)

    @pytest.mark.parametrize("new_shape", [(2, 4), (1, 8)])
    def test_restore_onto_different_mesh_shape(self, tmp_path, new_shape):
        """Re-sharding restore: a checkpoint written on a
        4x2 mesh restores straight onto a DIFFERENT mesh shape — the
        stated point of the orbax path (a pod that grew/shrank between
        runs). Values must match and the arrays must actually carry the
        new mesh's block sharding."""
        from fastdem_tpu.config.config import Config, MappingMode
        from fastdem_tpu.io.orbax_ckpt import load_orbax, save_orbax
        from fastdem_tpu.mapping.pipeline import create_map_state
        from fastdem_tpu.parallel import sharding as sh

        geom = GridGeometry.from_length(16.0, 16.0, 0.5)
        cfg = Config()
        cfg.mapping.mode = MappingMode.GLOBAL
        mesh_a = sh.make_mesh(8)  # 4x2
        assert tuple(mesh_a.devices.shape) == (4, 2)
        rng = np.random.default_rng(11)
        elev = rng.normal(0, 1, geom.shape).astype(np.float32)
        state = sh.shard_state(create_map_state(geom, cfg), mesh_a)
        state = state.replace_layer(layers.elevation, jnp.asarray(elev))
        path = str(tmp_path / "ckpt_remesh")
        save_orbax(path, geom, state)

        mesh_b = sh.make_mesh(8, shape=new_shape)
        geom2, state2, _ = load_orbax(path, sharding=sh.map_sharding(mesh_b))
        assert geom2 == geom
        got = state2.layers[layers.elevation]
        assert got.sharding.mesh.devices.shape == new_shape
        assert not got.sharding.is_fully_replicated
        np.testing.assert_array_equal(np.asarray(got), elev)
        # The restored state must be directly usable by a step built on
        # the new mesh (no resharding copies at first use).
        stepB, shardB = sh.build_sharded_integrate(
            geom2, cfg, mesh_b, donate=False
        )
        n = 512
        xyz = np.column_stack(
            [rng.uniform(-6, 6, n), rng.uniform(-6, 6, n),
             rng.normal(-1, 0.05, n)]
        ).astype(np.float32)
        out, _ = stepB(
            shardB(state2), jnp.asarray(xyz), jnp.ones(n, bool),
            jnp.eye(4), jnp.eye(4),
        )
        assert np.isfinite(
            np.asarray(out.layers[layers.elevation])
        ).sum() > 0


class TestMultiProcess:
    """True multi-process validation: 2 processes x 4 virtual CPU devices
    run the block-sharded global pipeline over one 8-device mesh; the
    assembled map must match a single-process 8-device run."""

    @pytest.mark.parametrize("batched", [0, 1])
    def test_two_process_matches_single(self, tmp_path, batched):
        import os
        import subprocess
        import sys

        out_multi = str(tmp_path / "mh.npz")
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        procs = []
        for pid in range(2):
            procs.append(
                subprocess.Popen(
                    [
                        sys.executable, "tools/multihost_demo.py",
                        "--pid", str(pid), "--nproc", "2",
                        "--coordinator", f"localhost:1241{1 + batched}",
                        "--scans", "4", "--points", "4096",
                        "--batched", str(batched),
                    ]
                    + ["--out", out_multi],
                    cwd=REPO, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )
            )
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
            assert p.returncode == 0, out[-2000:]
        assert os.path.exists(out_multi), outs[0][-1000:]

        # Single-process 8-device reference run of the same stream.
        import jax.numpy as jnp

        from fastdem_tpu import Config, GridGeometry, MappingMode
        from fastdem_tpu.io.npz import load_npz
        from fastdem_tpu.mapping.pipeline import build_integrate, create_map_state

        geom = GridGeometry.from_length(40.0, 40.0, 0.2)
        cfg = Config()
        cfg.mapping.mode = MappingMode.GLOBAL
        cfg.raycasting.enabled = True
        cfg.point_filter.range_max = 20.0
        step = build_integrate(geom, cfg, donate=False)
        state = create_map_state(geom, cfg)
        rng2 = np.random.default_rng(0)
        T_bs = jnp.eye(4).at[2, 3].set(1.0)
        for k in range(4):
            n = 4096
            ang = rng2.uniform(0, 2 * np.pi, n)
            rad = rng2.uniform(0.5, 18.0, n)
            xyz = np.column_stack(
                [rad * np.cos(ang), rad * np.sin(ang),
                 0.2 * np.sin(rad) - 1.0]
            ).astype(np.float32)
            state, _ = step(
                state, jnp.asarray(xyz), jnp.ones(n, bool), T_bs, jnp.eye(4)
            )

        _, state_mh, _ = load_npz(out_multi)
        np.testing.assert_allclose(
            np.asarray(state_mh.layers[layers.elevation]),
            np.asarray(state.layers[layers.elevation]),
            rtol=1e-5, atol=1e-6,
        )


class TestWeakScaling:
    def test_scaling_report_weak_mode(self):
        """Weak scaling: map area grows with the mesh;
        the report must size the sharded map rows*mx x cols*my and define
        efficiency as t_single / t_sharded."""
        from fastdem_tpu.config.config import Config, MappingMode
        from fastdem_tpu.parallel.distributed import scaling_report

        geom = GridGeometry.from_length(6.4, 6.4, 0.2)  # 32x32 per device
        cfg = Config()
        cfg.mapping.mode = MappingMode.GLOBAL
        rep = scaling_report(geom, cfg, scans=2, points=1024, mode="weak")
        assert rep["mode"] == "weak"
        assert rep["devices"] == 8
        assert rep["map_shape_sharded"] == (32 * 4, 32 * 2)  # 4x2 mesh
        assert rep["efficiency"] > 0
        assert abs(rep["speedup"] - rep["efficiency"] * 8) < 1e-9


class TestShardMapWindowed:
    """The shard_map windowed formulation: each device updates
    window-intersect-block locally — zero per-scan collectives — and the
    polar ray field is computed per-device from the replicated points."""

    @pytest.fixture(scope="class")
    def global_cfg(self):
        geom = GridGeometry.from_length(32.0, 32.0, 0.25)  # 128x128
        cfg = Config()
        cfg.mapping.mode = MappingMode.GLOBAL
        cfg.point_filter.range_max = 5.0  # window 64 << 128: gate engages
        cfg.raycasting.enabled = True
        return geom, cfg

    @pytest.fixture(scope="class")
    def reference_state(self, global_cfg):
        geom, cfg = global_cfg
        xyz, mask = scan(4000, seed=3)
        step1 = build_integrate(geom, cfg, donate=False, window_update=True)
        s1 = create_map_state(geom, cfg)
        for k in range(3):
            T_wb = I4.at[0, 3].set(1.5 * k).at[1, 3].set(-0.7 * k)
            s1, _ = step1(s1, xyz, mask, I4, T_wb)
        return s1

    def _run_sharded(self, geom, cfg, n_steps=3, seq=False, **kw):
        xyz, mask = scan(4000, seed=3)
        mesh = sh.make_mesh(8)
        if seq:
            seqN, shard = sh.build_sharded_integrate_sequence(
                geom, cfg, mesh, donate=False, **kw
            )
            T_wbs = jnp.stack(
                [
                    I4.at[0, 3].set(1.5 * k).at[1, 3].set(-0.7 * k)
                    for k in range(n_steps)
                ]
            )
            sN = shard(create_map_state(geom, cfg))
            return seqN(
                sN,
                jnp.broadcast_to(xyz, (n_steps,) + xyz.shape),
                jnp.broadcast_to(mask, (n_steps,) + mask.shape),
                I4,
                T_wbs,
            ), None
        stepN, shard = sh.build_sharded_integrate(
            geom, cfg, mesh, donate=False, **kw
        )
        sN = shard(create_map_state(geom, cfg))
        aux = None
        for k in range(n_steps):
            T_wb = I4.at[0, 3].set(1.5 * k).at[1, 3].set(-0.7 * k)
            sN, aux = stepN(sN, xyz, mask, I4, T_wb)
        return sN, aux

    def test_path_engages(self, global_cfg):
        geom, cfg = global_cfg
        mesh = sh.make_mesh(8)
        sh._shardmap_step(geom, cfg, mesh, False, False, False, None)

    def test_local_mode_falls_back(self):
        geom = GridGeometry.from_length(16.0, 16.0, 0.25)
        cfg = Config()  # LOCAL
        mesh = sh.make_mesh(8)
        with pytest.raises(ValueError):
            sh._shardmap_step(geom, cfg, mesh, False, False, False, None)

    def test_step_bitwise_equals_unsharded(self, global_cfg, reference_state):
        geom, cfg = global_cfg
        sN, aux = self._run_sharded(geom, cfg)
        assert aux.obs is None
        assert int(aux.oow_points) == 0
        for name in reference_state.layers:
            np.testing.assert_array_equal(
                np.asarray(reference_state.layers[name]),
                np.asarray(sN.layers[name]),
                err_msg=name,
            )

    def test_layers_actually_sharded(self, global_cfg):
        geom, cfg = global_cfg
        sN, _ = self._run_sharded(geom, cfg, n_steps=1)
        assert sN.layers[layers.elevation].sharding.is_fully_replicated \
            is False

    def test_sequence_bitwise_equals_unsharded(
        self, global_cfg, reference_state
    ):
        geom, cfg = global_cfg
        sS, _ = self._run_sharded(geom, cfg, seq=True)
        for name in reference_state.layers:
            np.testing.assert_array_equal(
                np.asarray(reference_state.layers[name]),
                np.asarray(sS.layers[name]),
                err_msg=name,
            )


class TestWindowedUnderGspmd:
    def test_windowed_step_matches_unsharded(self):
        """Window-local updates under GSPMD (dynamic slice + write-back on
        block-sharded layers): compiles and matches the unsharded windowed
        path exactly. The sharded BUILDERS pin window_update=False today
        (the slices insert per-scan collectives); this pins the
        combination's correctness so a future round can enable it from
        measurements alone."""
        geom = GridGeometry.from_length(32.0, 32.0, 0.25)  # 128x128
        cfg = Config()
        cfg.mapping.mode = MappingMode.GLOBAL
        cfg.point_filter.range_max = 5.0  # window ~46 cells << 128
        cfg.raycasting.enabled = True
        xyz, mask = scan(seed=3)

        step1 = build_integrate(
            geom, cfg, donate=False, window_update=True
        )
        s1 = create_map_state(geom, cfg)
        for k in range(2):
            T_wb = I4.at[0, 3].set(1.5 * k)
            s1, _ = step1(s1, xyz, mask, I4, T_wb)

        mesh = sh.make_mesh(8)
        raw = build_integrate(
            geom, cfg, jit=False, donate=False, window_update=True
        )
        st_sh = sh.state_shardings(mesh, create_map_state(geom, cfg))
        rep = sh.replicated(mesh)
        stepN = jax.jit(
            lambda s, *a: raw(s, *a),
            in_shardings=(st_sh, rep, rep, rep, rep),
            out_shardings=(st_sh, None),
        )
        sN = sh.shard_state(create_map_state(geom, cfg), mesh)
        for k in range(2):
            T_wb = I4.at[0, 3].set(1.5 * k)
            sN, _ = stepN(sN, xyz, mask, I4, T_wb)

        for name in s1.layers:
            np.testing.assert_array_equal(
                np.asarray(s1.layers[name]), np.asarray(sN.layers[name]),
                err_msg=name,
            )
