#!/usr/bin/env python
"""FastDEM benchmark. Prints ONE JSON line with the headline metric.

Headline config = the reference's own benchmark setting (README.md:41,53-59):
VLP-16-scale scans (~30K pts) into a 15x15 m @ 0.1 m robot-centric LOCAL map,
Kalman estimator + LiDAR noise model, raycasting enabled. Reference baseline:
~10 ms/scan on a Jetson Orin CPU (BASELINE.md).

Measurement: the per-scan integrate step is chained K times inside one jitted
lax.scan over pre-staged device-resident scans, so the number reflects pure
device throughput (scans staged in device memory, dispatch pipelined). The
other BASELINE.md configs (P2 estimator, RGB-D dense cloud, postprocess
chain, global map) run with --all.

Every result names the device it ran on (platform, device_kind, count).
The benchmark needs a GPU and stops without one; ``--platform cpu`` runs
it on the CPU on purpose and labels the results so.

Usage: python bench.py [--scans K] [--points N] [--no-raycast] [--all]
       [--platform gpu|cpu]
"""

import argparse
import json
import sys
import time

import numpy as np


def make_scans(K, N, rng, spread=7.2):
    ang = rng.uniform(0, 2 * np.pi, (K, N))
    rad = rng.uniform(0.5, spread, (K, N))
    x = rad * np.cos(ang)
    y = rad * np.sin(ang)
    z = 0.2 * np.sin(0.8 * x) * np.cos(0.6 * y) - 1.0 + rng.normal(
        0, 0.02, (K, N)
    )
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def chain_time(step, state, scans, masks, tx, pairs=10, compile_mode="aot"):
    import jax
    import jax.numpy as jnp

    T_bs = jnp.eye(4).at[2, 3].set(1.0)

    def body(state, inp):
        xyz, mask, txi = inp
        T_wb = jnp.eye(4).at[0, 3].set(txi)
        state, _ = step(state, xyz, mask, T_bs, T_wb)
        return state, ()

    @jax.jit
    def run(state, scans, masks, tx):
        state, _ = jax.lax.scan(body, state, (scans, masks, tx))
        return state

    K = scans.shape[0]
    t0 = time.time()
    # Compile path: "aot" compiles through run.lower(...).compile() with
    # XLA-chosen INPUT LAYOUTS and stages the operands into them before
    # timing; "jit" times plain jit dispatch (default layouts).
    # Layout.AUTO + device_put lets XLA lay the staged scans out freely,
    # as the replay staging does.
    def compile_with_auto_layout(*args):
        try:
            from jax.experimental.layout import Format, Layout

            auto = jax.jit(run, in_shardings=Format(Layout.AUTO))
            compiled = auto.lower(*args).compile()
            staged = tuple(
                jax.device_put(a, f)
                for a, f in zip(args, compiled.input_formats[0])
            )
            return compiled, staged
        except Exception as e:  # noqa: BLE001 — API drift: default layouts
            print(f"[auto-layout unavailable: {type(e).__name__}: {e}]",
                  file=sys.stderr)
            compiled = run.lower(*args).compile()
            return compiled, args

    if compile_mode == "aot":
        aot1, staged1 = compile_with_auto_layout(state, scans, masks, tx)
        jax.block_until_ready(aot1(*staged1).layers)

        def call_k():
            return aot1(*staged1)

    else:
        out = run(state, scans, masks, tx)
        jax.block_until_ready(out.layers)

        def call_k():
            return run(state, scans, masks, tx)

    compile_s = time.time() - t0

    # Two-length difference estimator: each run() call pays a fixed cost D
    # (dispatch, host sync) on top of the K scans of device work,
    # T(K) = D + K*s. Timing the SAME step chained over K and 2K scans and
    # differencing cancels D in expectation. MEDIANS of the two legs over
    # ``pairs`` interleaved repetitions, differenced, drop stall tails on
    # both legs. Falls back to the raw quotient (D-inflated, i.e.
    # conservative) if the 2K variant fails.
    diff = True
    try:
        scans2 = jnp.concatenate([scans, scans])
        masks2 = jnp.concatenate([masks, masks])
        tx2 = jnp.concatenate([tx, tx])
        if compile_mode == "aot":
            aot2, staged2 = compile_with_auto_layout(
                state, scans2, masks2, tx2
            )
            jax.block_until_ready(aot2(*staged2).layers)

            def call_2k():
                return aot2(*staged2)

        else:
            out2 = run(state, scans2, masks2, tx2)
            jax.block_until_ready(out2.layers)

            def call_2k():
                return run(state, scans2, masks2, tx2)

        compile_s = time.time() - t0
    except Exception as e:  # noqa: BLE001
        print(f"2K chain failed ({e}); raw quotient only", file=sys.stderr)
        diff = False
    from fastdem_tpu.utils.benchtime import median, two_length_diff_ms

    def run_k():
        jax.block_until_ready(call_k().layers)

    if not diff:
        t1s = []
        for _ in range(3):
            t0 = time.time()
            run_k()
            t1s.append(time.time() - t0)
        return median(t1s) / K * 1e3, compile_s

    def run_2k():
        jax.block_until_ready(call_2k().layers)

    ms, per_pair, med_k = two_length_diff_ms(run_k, run_2k, K, pairs=pairs)
    raw = med_k / K * 1e3
    print(
        f"    [chain: device {ms:.3f} ms/scan (median-of-{pairs} pairs; "
        f"per-pair {min(per_pair):.3f}..{max(per_pair):.3f}); raw K={K} "
        f"quotient {raw:.3f} incl. ~{max(raw - ms, 0.0):.3f} dispatch/scan]",
        file=sys.stderr,
    )
    chain_time.last = {
        "ms": round(ms, 4),
        "pairs": pairs,
        "per_pair_min": round(min(per_pair), 4),
        "per_pair_max": round(max(per_pair), 4),
        "raw_quotient": round(raw, 4),
        "K": K,
        "compile_s": round(compile_s, 1),
        "compile_mode": compile_mode,
    }
    return ms, compile_s


def fused_time(fused, state, scans, masks, tx, reps=3):
    import jax
    import jax.numpy as jnp
    import numpy as np_

    K = scans.shape[0]
    T_bs = jnp.eye(4).at[2, 3].set(1.0)
    poses = np_.tile(np_.eye(4, dtype=np_.float32), (K, 1, 1))
    poses[:, 0, 3] = np_.asarray(tx)
    poses = jnp.asarray(poses)

    t0 = time.time()
    out = fused(state, scans, masks, T_bs, poses)
    jax.block_until_ready(out.layers)
    compile_s = time.time() - t0
    t0 = time.time()
    for _ in range(reps):
        out = fused(state, scans, masks, T_bs, poses)
    jax.block_until_ready(out.layers)
    return (time.time() - t0) / (reps * K) * 1e3, compile_s


def bench_pipeline(K, N, cfg_mut=None, spread=7.2, geom_m=15.0, res=0.1,
                   scatter_mode="rows", fused=False, compile_mode="aot"):
    # scatter_mode default MUST match build_integrate's production default
    # ("rows"), and every config branch forwards --scatter-mode.
    import jax.numpy as jnp

    sys.path.insert(0, ".")
    from fastdem_tpu import Config, GridGeometry
    from fastdem_tpu.mapping.pipeline import (
        build_integrate,
        build_integrate_fused,
        create_map_state,
    )

    geom = GridGeometry.from_length(geom_m, geom_m, res)
    cfg = Config()
    cfg.raycasting.enabled = True
    if cfg_mut:
        cfg_mut(cfg)
    rng = np.random.default_rng(0)
    scans = jnp.asarray(make_scans(K, N, rng, spread))
    masks = jnp.ones((K, N), dtype=bool)
    tx = jnp.asarray(np.cumsum(rng.normal(0, 0.05, K)).astype(np.float32))
    state = create_map_state(geom, cfg)
    if fused:
        fn = build_integrate_fused(
            geom, cfg, donate=False, scatter_mode=scatter_mode
        )
        return fused_time(fn, state, scans, masks, tx)
    step = build_integrate(geom, cfg, jit=False, scatter_mode=scatter_mode)
    return chain_time(step, state, scans, masks, tx,
                      compile_mode=compile_mode)


def bench_postprocess(log, compile_mode="aot"):
    """Post-processing chain on a snapshot (UF + inpaint + FE), chained
    with the two-length difference estimator (the fixed per-call cost
    otherwise dominates the small snapshot's chain).

    Two rows: the 150x150 LOCAL snapshot and the 2000x2000 GLOBAL map —
    the reference's async postprocess cadence runs on the global preset
    (ros2/config/global_mapping.yaml, 200x200 m @ 0.1 m;
    src/uncertainty_fusion.cpp:103-186). The 150x150 chain sits near the
    estimator's noise floor, so the row carries an explicit error bar and
    a ``clamped`` flag + dispatch-inflated upper bound instead of
    committing the 1e-4 clamp as a measurement."""
    import jax
    import jax.numpy as jnp

    from fastdem_tpu import GridGeometry, PostProcessConfig
    from fastdem_tpu.postprocess import apply_postprocess_fn
    from fastdem_tpu.utils.benchtime import two_length_diff_ms

    def one(geom_m, res, Kpp, pairs, name, label):
        geom = GridGeometry.from_length(geom_m, geom_m, res)
        pp = PostProcessConfig()
        pp.inpainting.enabled = True
        pp.uncertainty_fusion.enabled = True
        pp.feature_extraction.enabled = True
        fn = apply_postprocess_fn(geom, pp)
        rng = np.random.default_rng(0)
        elev = jnp.asarray(rng.normal(0, 0.1, geom.shape).astype(np.float32))

        def make_pp(length):
            def run_pp(e):
                def body(c, _):
                    out = fn(c, c + 0.1, c - 0.1)
                    return out["elevation"] + out["slope"] * 1e-9, ()

                o, _ = jax.lax.scan(body, e, None, length=length)
                return o

            if compile_mode == "aot":
                return jax.jit(run_pp).lower(elev).compile()
            return jax.jit(run_pp)

        pp1, pp2 = make_pp(Kpp), make_pp(2 * Kpp)

        def sync(fn):
            # Completion fence: a device->host fetch of one element of the
            # final carry. The fetch is one tiny extra transfer per call —
            # constant in K, cancelled by the difference.
            return float(jax.device_get(fn(elev)[0, 0]))

        sync(pp1)
        sync(pp2)
        ms_pp, per_pair, med_k = two_length_diff_ms(
            lambda: sync(pp1),
            lambda: sync(pp2),
            Kpp, pairs=pairs,
        )
        raw = med_k / Kpp * 1e3  # dispatch-inflated upper bound
        clamped = ms_pp <= 1e-4 or ms_pp < (max(per_pair) - min(per_pair))
        log(f"postprocess UF+inp+FE ({label})", max(ms_pp, 1e-4), 0)
        row = {
            "config": name,
            "ms": None if clamped else round(ms_pp, 4),
            "clamped": clamped,
            "upper_bound_ms": round(raw, 4),
            "per_pair_min": round(min(per_pair), 4),
            "per_pair_max": round(max(per_pair), 4),
            "K": Kpp,
            "pairs": pairs,
            "compile_mode": compile_mode,
            # Different metric than the per-scan rows: the async
            # postprocess timer chain has no ~10 ms/scan baseline.
            "vs_baseline": None,
            "note": f"ms per UF+inpaint+FE pass on a {label} snapshot; "
                    "two-length difference estimator; upper_bound_ms is "
                    "the dispatch-inflated raw K-leg quotient",
        }
        print("BENCHCFG " + json.dumps(row), flush=True)

    one(15.0, 0.1, 256, 8, "postprocess_uf_inpaint_fe_15m", "150x150")
    one(200.0, 0.1, 16, 8, "postprocess_uf_inpaint_fe_200m", "2000x2000")

    if jax.device_count() > 1:
        from fastdem_tpu.config.config import Config, MappingMode
        from fastdem_tpu.parallel.distributed import scaling_report

        geom_g = GridGeometry.from_length(50.0, 50.0, 0.1)
        cfg_g = Config()
        cfg_g.mapping.mode = MappingMode.GLOBAL
        rep = scaling_report(geom_g, cfg_g, scans=8)
        print(f"sharded global map: {rep}", file=sys.stderr)


def run_all(args):
    """--all orchestrator: one subprocess per config, strictly sequential,
    parent device-free (see the note at the --all branch in main).

    BASELINE.md's measured configs run FIRST (headline, p2, rgbd, global,
    postprocess); the fused A/B harness runs last — its vmapped program
    has the longest compile and the least information value, so a
    wall-clock-bounded session still gets the rows that matter. The
    artifact (--out) is rewritten after every config, so a killed run
    keeps everything measured so far.
    """
    import subprocess

    collected = []
    device = None
    names = ("headline", "p2", "rgbd", "rgbd_masked", "global",
             "postprocess", "fused")
    if args.only:
        only = set(args.only.split(","))
        unknown = only - set(names)
        if unknown:
            print(f"[--all] unknown --only configs: {sorted(unknown)}",
                  file=sys.stderr)
            return 1
        names = tuple(n for n in names if n in only)
    for name in names:
        cmd = [sys.executable, __file__, "--config", name,
               "--scans", str(args.scans), "--points", str(args.points),
               "--scatter-mode", args.scatter_mode,
               "--compile-mode", args.compile_mode,
               "--platform", args.platform]
        if args.no_raycast and name in ("headline", "fused"):
            cmd.append("--no-raycast")
        if args.trace and name == "headline":
            cmd += ["--trace", args.trace]
        try:
            r = subprocess.run(
                cmd, capture_output=True, text=True, timeout=4200
            )
        except subprocess.TimeoutExpired:
            print(f"[--all] config {name} timed out; skipping",
                  file=sys.stderr)
            continue
        for line in r.stderr.splitlines():
            if "ms/scan" in line or "chain:" in line or "win:" in line:
                print(line, file=sys.stderr)
        for line in r.stdout.splitlines():
            if line.startswith("BENCHCFG "):
                row = json.loads(line[len("BENCHCFG "):])
                device = device or row.get("device")
                collected.append(row)
        if r.returncode != 0:
            print(f"[--all] config {name} failed:\n{r.stderr[-800:]}",
                  file=sys.stderr)
        if args.out:  # incremental: survive a wall-clock kill
            artifact = {
                "device": device,
                "baseline_ms": 10.0,
                "estimator": "two-length difference, median-of-pairs "
                             "(see chain_time)",
                "isolation": "each config in its own process, strictly "
                             "sequential: one process per card",
                "configs": collected,
            }
            with open(args.out, "w") as f:
                json.dump(artifact, f, indent=2)
                f.write("\n")
            print(f"wrote {args.out} ({len(collected)} rows)",
                  file=sys.stderr)

    head = next(
        (c for c in collected
         if c["config"] == "local_kalman_lidar_raycast_15m"),
        None,
    )
    if head is None:
        print("[--all] headline config missing from results", file=sys.stderr)
        return 1
    print(json.dumps({
        "metric": "ms_per_scan_vlp16_15m_kalman_raycast",
        "value": head["ms"],
        "unit": "ms/scan",
        "vs_baseline": round(10.0 / head["ms"], 2),
        "device": device,
    }))
    return 0


def main():
    ap = argparse.ArgumentParser()
    # K=64 scans per chained call dilutes the fixed per-call cost.
    ap.add_argument("--scans", type=int, default=64)
    ap.add_argument("--points", type=int, default=30000)
    ap.add_argument("--no-raycast", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="also run the other BASELINE.md configs (each in "
                         "its own subprocess; one process per card)")
    ap.add_argument("--config", default=None,
                    choices=["headline", "fused", "p2", "rgbd",
                             "rgbd_masked", "global", "postprocess"],
                    help="run ONE config and exit (used by --all's "
                         "per-config subprocesses)")
    ap.add_argument("--scatter-mode", default="rows",
                    choices=["rows", "packed", "twophase", "sort"],
                    help="rasterizer formulation (A/B within one session)")
    ap.add_argument("--compile-mode", default="aot",
                    choices=["aot", "jit"],
                    help="compile the chain via lower().compile() with "
                         "XLA-chosen input layouts (aot) or jit dispatch "
                         "(jit)")
    ap.add_argument("--fused", action="store_true",
                    help="also measure the K-fused offline-replay program")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a jax.profiler trace of the headline "
                         "run into DIR (view with tensorboard/xprof)")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="with --all: write every config's stats as one "
                         "JSON file, rewritten after each config")
    ap.add_argument("--only", default=None, metavar="A,B",
                    help="with --all: run only these configs "
                         "(comma-separated subset)")
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"],
                    help="device to measure: gpu (default; stops when JAX "
                         "finds none) or cpu (on purpose; results are "
                         "labelled cpu)")
    args = ap.parse_args()

    if args.all:
        # Orchestrate every config as its OWN subprocess with the parent
        # never initializing the device: one JAX process per card (a JAX
        # process reserves most of the card's memory when it starts).
        return run_all(args)

    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ".")
    from fastdem_tpu.runtime.aotcache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != args.platform:
        print(f"bench: asked for {args.platform} but JAX found "
              f"{dev.platform} ({dev.device_kind}); stopping",
              file=sys.stderr)
        return 2
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": jax.device_count()}
    print(f"device: {json.dumps(device)}", file=sys.stderr)
    baseline_ms = 10.0  # reference ~10 ms/scan (BASELINE.md)

    def log(name, ms, compile_s):
        print(
            f"{name:>34}: {ms:7.3f} ms/scan ({1000.0/ms:6.0f} scans/s, "
            f"{baseline_ms/ms:4.1f}x baseline, compile {compile_s:.0f}s)",
            file=sys.stderr,
        )

    collected = []

    def emit_cfg(config, ms, note=None):
        """One machine-readable stats line per config, with the device it
        ran on (collected by --all into --out)."""
        stats = dict(getattr(chain_time, "last", None) or {"ms": round(ms, 4)})
        stats["config"] = config
        stats["device"] = device
        stats["vs_baseline"] = round(baseline_ms / ms, 2)
        if note is not None:
            stats["note"] = note
        chain_time.last = None
        print("BENCHCFG " + json.dumps(stats), flush=True)
        collected.append(stats)

    def mut_headline(cfg):
        cfg.raycasting.enabled = not args.no_raycast

    if args.config == "fused":
        msf, cf = bench_pipeline(
            args.scans, args.points, mut_headline,
            scatter_mode=args.scatter_mode, fused=True,
        )
        log("K-fused offline replay", msf, cf)
        emit_cfg(
            "kfused_offline_replay_15m", msf,
            note="A/B harness (vmapped phase A), raw-quotient estimator",
        )
        return
    if args.config == "postprocess":
        bench_postprocess(log, compile_mode=args.compile_mode)
        return
    if args.config == "p2":
        from fastdem_tpu.config.config import EstimationType

        def mut_p2(cfg):
            cfg.mapping.estimation_type = EstimationType.P2_QUANTILE

        ms2, c2 = bench_pipeline(args.scans, args.points, mut_p2,
                                 scatter_mode=args.scatter_mode,
                                 compile_mode=args.compile_mode)
        log("p2 quantile + lidar + raycast", ms2, c2)
        emit_cfg("p2_lidar_raycast_15m", ms2)
        return
    if args.config == "rgbd":
        from fastdem_tpu.config.config import SensorType

        def mut_rgbd(cfg):
            cfg.raycasting.enabled = False
            cfg.sensor_model.type = SensorType.RGBD

        # Cap the chain at K=16 as a device-memory precaution (the 2K leg
        # stages 2K*300K points of scan buffers — 230 MB at K=32).
        ms3, c3 = bench_pipeline(
            max(4, min(16, args.scans // 2)), 300000, mut_rgbd, spread=6.0,
            scatter_mode=args.scatter_mode,
            compile_mode=args.compile_mode,
        )
        log("rgbd 300K pts local", ms3, c3)
        emit_cfg("rgbd_300k_15m", ms3)
        return
    if args.config == "rgbd_masked":
        # 300K-capacity RGB-D frames with 60% invalid depth returns: masked
        # scatter rows still pay per index, so the unbucketed program
        # costs ~300K points' worth for 120K valid ones.
        # FastDEM.integrate auto-compacts such frames to the geometric
        # capacity ladder (131072 here); this config measures BOTH programs
        # on the SAME valid points in one process — the delta is the pure
        # capacity win.
        import jax.numpy as jnp

        sys.path.insert(0, ".")
        from fastdem_tpu import Config, GridGeometry
        from fastdem_tpu.cloud.pointcloud import ladder_capacity
        from fastdem_tpu.config.config import SensorType
        from fastdem_tpu.mapping.pipeline import (
            build_integrate,
            create_map_state,
        )

        K, N, n_valid = max(4, args.scans // 2), 300000, 120000
        cap_b = ladder_capacity(n_valid)
        geom = GridGeometry.from_length(15.0, 15.0, 0.1)
        cfg = Config()
        cfg.raycasting.enabled = False
        cfg.sensor_model.type = SensorType.RGBD
        rng = np.random.default_rng(0)
        scans = make_scans(K, N, rng, spread=6.0)
        masks = np.zeros((K, N), dtype=bool)
        comp = np.full((K, cap_b, 3), 1e9, dtype=np.float32)
        comp_masks = np.zeros((K, cap_b), dtype=bool)
        for k in range(K):
            valid = np.sort(rng.choice(N, n_valid, replace=False))
            masks[k, valid] = True
            comp[k, :n_valid] = scans[k, valid]
            comp_masks[k, :n_valid] = True
        scans[~masks] = 1e9  # sentinel like from_numpy padding
        tx = jnp.asarray(np.cumsum(rng.normal(0, 0.05, K)).astype(np.float32))
        state = create_map_state(geom, cfg)
        step = build_integrate(geom, cfg, jit=False)
        ms_f, c_f = chain_time(
            step, state, jnp.asarray(scans), jnp.asarray(masks), tx,
            compile_mode=args.compile_mode,
        )
        log("rgbd 300K cap, 120K valid (full)", ms_f, c_f)
        emit_cfg("rgbd_300k_masked60_fullcap", ms_f)
        ms_b, c_b = chain_time(
            step, state, jnp.asarray(comp), jnp.asarray(comp_masks), tx,
            compile_mode=args.compile_mode,
        )
        log(f"same, bucketed cap {cap_b}", ms_b, c_b)
        emit_cfg("rgbd_300k_masked60_bucketed", ms_b)
        print(f"    [bucketing win: {ms_f / ms_b:.2f}x]", file=sys.stderr)
        return
    if args.config == "global":
        # GLOBAL 200 m @ 0.1 m (4M cells), 20 m range: exercises the
        # window-local update path (O(range^2) per scan).
        from fastdem_tpu.config.config import MappingMode

        def mut_global(cfg):
            cfg.mapping.mode = MappingMode.GLOBAL
            cfg.point_filter.range_max = 20.0

        ms4, c4 = bench_pipeline(
            max(4, args.scans // 4), args.points, mut_global, spread=18.0,
            geom_m=200.0, scatter_mode=args.scatter_mode,
            compile_mode=args.compile_mode,
        )
        log("global 200m 4M cells + raycast", ms4, c4)
        emit_cfg("global_200m_raycast", ms4)
        return

    if args.trace:
        # Warm (compile) once, then trace a single timed run.
        bench_pipeline(args.scans, args.points, mut_headline,
                       scatter_mode=args.scatter_mode,
                       compile_mode=args.compile_mode)
        with jax.profiler.trace(args.trace):
            ms, comp = bench_pipeline(
                args.scans, args.points, mut_headline,
                scatter_mode=args.scatter_mode,
                compile_mode=args.compile_mode,
            )
        print(f"trace -> {args.trace}", file=sys.stderr)
    else:
        ms, comp = bench_pipeline(
            args.scans, args.points, mut_headline,
            scatter_mode=args.scatter_mode,
            compile_mode=args.compile_mode,
        )
    log("local kalman lidar + raycast", ms, comp)
    emit_cfg("local_kalman_lidar_raycast_15m", ms)

    if args.fused:
        msf, cf = bench_pipeline(
            args.scans, args.points, mut_headline,
            scatter_mode=args.scatter_mode, fused=True,
        )
        log("same, K-fused offline replay", msf, cf)
        emit_cfg("kfused_offline_replay_15m", msf)

    print(
        json.dumps(
            {
                "metric": "ms_per_scan_vlp16_15m_kalman_raycast",
                "value": round(ms, 4),
                "unit": "ms/scan",
                "vs_baseline": round(baseline_ms / ms, 2),
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
