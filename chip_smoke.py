#!/usr/bin/env python
"""Bring-up check: the mapping pipeline on one GPU, at deployment size.

Everything runs in ONE process that holds the card(s):

  1. device   JAX must find a GPU. Prints device_kind, the device count
              and the card (nvidia-smi name and power limit).
  2. node     The reference deployment: tools/fastdem_node.main with
              local_mapping.yaml (robot-centric 15x15 m @ 0.1 m, Kalman,
              LiDAR model, raycasting, inpainting, uncertainty fusion,
              features) over 20 synthetic VLP-16-like 30K-point scans.
              Checks coverage and heights of the written map.
  3. global   FastDEM.integrate on a fixed-origin 200x200 m @ 0.1 m map
              (4M cells; Kalman, LiDAR, raycasting, 20 m range) over 20
              scans of 30K points to 18 m along a moving pose, then UF +
              inpaint + FE over the whole map. Prints compile seconds,
              memory analysis, peak device memory and warm per-scan wall
              time.
  4. parity   The frozen golden sessions replayed on the GPU; the phase-3
              stream and post-processing on the GPU vs the CPU backend of
              this process; the polar ray field on the GPU vs the CPU.

``--multi`` (four GPUs) runs only the phase-3 stream block-sharded over a
2x2 mesh, through the shard_map windowed path and the GSPMD path, and
compares each bitwise with the one-card run of the same stream.

The last line of stdout is ``{"ok": true, "device": {...}}``. A failed
check lets the later phases still report, then exits non-zero without
that line; a phase that cannot go on exits at once.

Usage: python chip_smoke.py [--multi] [--out DIR]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SENSOR_HEIGHT = 1.0
SYNTH_NOISE = 0.02  # sigma of the synthetic scans' z noise [m]

# Parity tolerances. Decision layers: the golden test's own bound.
RTOL, ATOL = 1e-5, 1e-6
# Visibility log-odds and the min-ray-height diagnostic may differ on at
# most this share of cells: rays at polar-bin boundaries land in the
# neighbouring bin when atan2 / FMA contraction differ in the last ulp
# between backends (PARITY.md, offline-replay row).
ENVELOPE_SHARE = 1e-3
# Polar field heights: FMA contraction of h = z0 + slope * d.
POLAR_ATOL = 4e-6

DECISION_LAYERS = (
    "elevation", "elevation_min", "elevation_max", "variance", "n_points",
    "obstacle",
)
ENVELOPE_LAYERS = ("_visibility_logodds", "raycasting")


def fail(msg):
    """A phase that cannot go on: stop now."""
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


class Checks:
    """The failed checks of one run. A failed check does not stop the
    later phases, which still report; any failure makes the exit code
    non-zero."""

    def __init__(self):
        self.failed = []

    def __call__(self, ok, msg):
        if not ok:
            self.failed.append(msg)
            print(f"chip_smoke: CHECK FAILED: {msg}", file=sys.stderr,
                  flush=True)
        return ok


def log(msg):
    print(msg, flush=True)


def terrain(x, y):
    """World terrain height of every synthetic stream here and in
    tools/fastdem_node.py's synthetic scans."""
    return 0.25 * np.sin(0.6 * x) * np.cos(0.5 * y)


# ---------------------------------------------------------------- phase 1


def card_lines():
    """nvidia-smi's name and power limit per card (a child process that
    does not import JAX)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:
        fail("nvidia-smi not found")
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return [line.strip() for line in r.stdout.strip().splitlines()]


def phase_device(need):
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        fail(f"JAX found no GPU (default device: {dev.platform}, "
             f"{dev.device_kind})")
    n = len(jax.devices())
    if n < need:
        fail(f"{need} GPUs needed, JAX sees {n}")
    cards = card_lines()
    log(f"[device] platform={dev.platform} device_kind={dev.device_kind} "
        f"count={n}")
    for line in cards:
        log(f"[device] card: {line}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": n}, cards


# ---------------------------------------------------------------- phase 2


def load_node():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "fastdem_node", os.path.join(ROOT, "tools", "fastdem_node.py")
    )
    node = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(node)
    return node


def height_error(geom, state):
    """(mapped share, median |elevation - terrain|) of a map state."""
    elev = np.asarray(state.layers["elevation"])
    cx, cy = geom.cell_centers(state.position)
    h = terrain(np.asarray(cx), np.asarray(cy))
    mapped = np.isfinite(elev)
    if not mapped.any():
        return 0.0, float("inf")
    return float(mapped.mean()), float(
        np.median(np.abs(elev[mapped] - h[mapped]))
    )


def phase_node(check, out_dir, n_scans=20,
               config="fastdem_tpu/config/presets/local_mapping.yaml"):
    from fastdem_tpu.io.npz import load_npz

    node = load_node()
    t0 = time.time()
    rc = node.main(["--config", os.path.join(ROOT, config),
                    "--synthetic", str(n_scans), "--out", out_dir])
    if rc != 0:
        fail(f"fastdem_node exited {rc}")
    geom, state, _ = load_npz(os.path.join(out_dir, "map_final.npz"))
    share, err = height_error(geom, state)
    log(f"[node] {n_scans} scans in {time.time() - t0:.1f} s wall (incl. "
        f"compiles); map {geom.shape}; mapped share {share:.4f}; median "
        f"|elevation - terrain| {err:.5f} m")
    check(share > 0.5, f"node mapped only {share:.3f} of the cells")
    # The elevation fuses per-scan MIN-z observations (reference
    # semantics) of scans with SYNTH_NOISE noise, which biases it low by
    # about half that sigma; the bound is the noise sigma.
    check(err < SYNTH_NOISE,
          f"node heights off the terrain: median |err| {err:.4f} m")
    return share, err


# ---------------------------------------------------------------- phase 3


def global_config(range_max=20.0):
    import fastdem_tpu as fd

    cfg = fd.Config()
    cfg.mapping.mode = fd.MappingMode.GLOBAL
    cfg.mapping.estimation_type = fd.EstimationType.KALMAN
    cfg.sensor_model.type = fd.SensorType.LIDAR
    cfg.raycasting.enabled = True
    cfg.point_filter.range_max = range_max
    return cfg


def global_stream(n_scans=20, n_points=30000, spread=18.0, seed=0,
                  step=0.6):
    """Sensor-frame scans of the terrain along a moving pose.
    Returns [(xyz f32[N, 3], T_wb f32[4, 4])]."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_scans):
        ang = rng.uniform(0, 2 * np.pi, n_points)
        rad = rng.uniform(0.5, spread, n_points)
        x, y = rad * np.cos(ang), rad * np.sin(ang)
        T_wb = np.eye(4, dtype=np.float32)
        T_wb[0, 3] = step * k
        T_wb[1, 3] = 0.4 * step * k
        z = terrain(x + T_wb[0, 3], y + T_wb[1, 3]) - SENSOR_HEIGHT
        z = z + rng.normal(0, SYNTH_NOISE, n_points)
        out.append((np.column_stack([x, y, z]).astype(np.float32), T_wb))
    return out


def sensor_extrinsic():
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = SENSOR_HEIGHT
    return T_bs


def postprocess_config():
    import fastdem_tpu as fd

    pp = fd.PostProcessConfig()
    pp.uncertainty_fusion.enabled = True
    pp.inpainting.enabled = True
    pp.feature_extraction.enabled = True
    return pp


def run_facade(geom, cfg, stream, device=None):
    """Integrate ``stream`` through FastDEM.integrate on ``device``.
    Returns (mapper, stats) with first-call and warm per-scan seconds."""
    import contextlib

    import jax
    import jax.numpy as jnp

    import fastdem_tpu as fd
    from fastdem_tpu.cloud import pointcloud as pc

    ctx = jax.default_device(device) if device else contextlib.nullcontext()
    T_bs = sensor_extrinsic()
    with ctx:
        mapper = fd.FastDEM(geom, cfg)
        clouds = [pc.from_numpy(xyz, frame_id="lidar") for xyz, _ in stream]
        # Compile the step explicitly first, to report its compile time
        # and memory analysis.
        c0 = clouds[0]
        t0 = time.time()
        compiled = mapper._step.lower(
            mapper.state, c0.xyz, c0.mask, jnp.asarray(T_bs),
            jnp.asarray(stream[0][1]), None, None,
        ).compile()
        compile_s = time.time() - t0
        times = []
        for cloud, (_, T_wb) in zip(clouds, stream):
            t0 = time.perf_counter()
            if not mapper.integrate(cloud, T_bs, T_wb):
                fail("FastDEM.integrate dropped a scan")
            jax.block_until_ready(mapper.state.layers["elevation"])
            times.append(time.perf_counter() - t0)
    return mapper, {
        "compile_s": compile_s,
        "memory": compiled.memory_analysis(),
        "first_call_s": times[0],
        "warm_ms": [t * 1e3 for t in times[1:]],
    }


def run_postprocess(geom, pp, layers, device, reps=1):
    """UF + inpaint + FE over the whole map on ``device``. Returns
    (outputs as numpy, compile seconds, warm milliseconds of ``reps``
    calls)."""
    import jax

    from fastdem_tpu.postprocess import apply_postprocess_fn

    fn = jax.jit(apply_postprocess_fn(geom, pp))
    args = [jax.device_put(np.asarray(layers[k]), device)
            for k in ("elevation", "upper_bound", "lower_bound")]
    t0 = time.time()
    compiled = fn.lower(*args).compile()
    compile_s = time.time() - t0
    out = compiled(*args)
    jax.block_until_ready(out)
    warm_ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = compiled(*args)
        jax.block_until_ready(out)
        warm_ms.append((time.perf_counter() - t0) * 1e3)
    return {k: np.asarray(v) for k, v in out.items()}, compile_s, warm_ms


def phase_global(check, card, map_m=200.0, n_scans=20, n_points=30000,
                 spread=18.0, range_max=20.0):
    import jax

    import fastdem_tpu as fd

    geom = fd.GridGeometry.from_length(map_m, map_m, 0.1)
    cfg = global_config(range_max)
    stream = global_stream(n_scans, n_points, spread)
    gpu = jax.devices()[0]
    mapper, st = run_facade(geom, cfg, stream)
    share, err = height_error(geom, mapper.state)
    warm = np.asarray(st["warm_ms"])
    log(f"[global] map {geom.shape} ({geom.num_cells} cells), {n_scans} "
        f"scans x {n_points} pts; card {card}")
    log(f"[global] integrate compile {st['compile_s']:.2f} s; first call "
        f"{st['first_call_s']:.2f} s; memory {st['memory']}")
    log(f"[global] integrate warm per-scan wall ms: median "
        f"{np.median(warm):.4f} min {warm.min():.4f} max {warm.max():.4f} "
        f"(n={warm.size}; card {card})")
    log(f"[global] mapped share {share:.4f}; median |elevation - terrain| "
        f"{err:.5f} m")
    check(err < SYNTH_NOISE,
          f"global heights off the terrain: median |err| {err:.4f} m")
    pp = postprocess_config()
    out, pc_s, pw_ms = run_postprocess(geom, pp, mapper.state.layers, gpu,
                                       reps=5)
    bad = [k for k, v in out.items() if v.shape != geom.shape]
    check(not bad, f"post-processing output shapes wrong: {bad}")
    finite = np.isfinite(out["elevation"]).mean()
    log(f"[global] postprocess UF+inpaint+FE compile {pc_s:.2f} s; warm "
        f"median {np.median(pw_ms):.3f} ms (min {min(pw_ms):.3f}, max "
        f"{max(pw_ms):.3f}, n={len(pw_ms)}; card {card}); finite elevation "
        f"share {finite:.4f}")
    check(finite >= share, "inpainting lost mapped cells")
    stats = gpu.memory_stats() or {}
    log(f"[global] peak_bytes_in_use {stats.get('peak_bytes_in_use')} "
        f"(card {card})")
    return geom, cfg, stream, mapper, out


# ---------------------------------------------------------------- phase 4


def diff_cells(a, b, rtol=RTOL, atol=ATOL):
    """Cells where a and b disagree: NaN-mask mismatch or a value outside
    rtol/atol (assert_allclose semantics). Returns (count, max |a - b|)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    na, nb = np.isnan(a), np.isnan(b)
    both = ~na & ~nb
    with np.errstate(invalid="ignore"):
        d = np.abs(a - b)
        same_inf = both & np.isinf(a) & (a == b)
        over = both & ~same_inf & ~(d <= atol + rtol * np.abs(b))
    dmax = float(np.max(d[both & ~same_inf])) if (both & ~same_inf).any() \
        else 0.0
    return int((na != nb).sum() + over.sum()), dmax


def compare_maps(tag, got, want, decision, envelope):
    """Decision layers within RTOL/ATOL; envelope layers on at most
    ENVELOPE_SHARE of the cells. Every compared layer is printed.

    A ghost-clear decision (``ghost_removal``) follows the log-odds, so a
    cell whose clear decision differs is an envelope cell: it is counted
    against ENVELOPE_SHARE and left out of the decision layers' exact
    comparison (a cleared cell is NaN in every layer)."""
    ok = True
    size = np.asarray(next(iter(want.values()))).size
    clear_diff = np.zeros(np.asarray(next(iter(want.values()))).shape, bool)
    if "ghost_removal" in got and "ghost_removal" in want:
        clear_diff = (np.asarray(got["ghost_removal"]) == 1) != (
            np.asarray(want["ghost_removal"]) == 1
        )
        share = clear_diff.sum() / size
        log(f"[{tag}] ghost-clear decision differs on {clear_diff.sum()} "
            f"cells ({share:.6f}) [envelope]")
        ok = share <= ENVELOPE_SHARE
    for name in sorted(set(got) & set(want)):
        a, b = np.asarray(got[name]), np.asarray(want[name])
        gate = ("exact" if name in decision else
                "envelope" if name in envelope else "report")
        if gate == "exact" and clear_diff.any():
            a, b = a[~clear_diff], b[~clear_diff]
        n, dmax = diff_cells(a, b)
        log(f"[{tag}] {name}: {n} cells differ ({n / size:.6f}), max |d| "
            f"{dmax:.3g} [{gate}]")
        if gate == "exact" and n:
            ok = False
        if gate == "envelope" and n / size > ENVELOPE_SHARE:
            ok = False
    missing = [k for k in decision + envelope if k in want and k not in got]
    if missing:
        fail(f"{tag}: layers missing: {missing}")
    return ok


def phase_goldens(check):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_goldens

    for est in ("kalman", "p2"):
        _, state = test_goldens.run_session(est)
        with np.load(test_goldens.golden_path(est)) as data:
            want = {k: data[k] for k in test_goldens.GOLDEN_LAYERS}
        got = {k: np.asarray(state.layers[k]) for k in want}
        decision = tuple(k for k in want if k not in ENVELOPE_LAYERS)
        check(compare_maps(f"golden {est}", got, want, decision,
                           ENVELOPE_LAYERS),
              f"golden session {est} drifted on the GPU")


def phase_parity(check, geom, cfg, stream, mapper_gpu, pp_gpu, cpu):
    mapper_cpu, st = run_facade(geom, cfg, stream, device=cpu)
    log(f"[parity] CPU run of the global stream: warm median "
        f"{np.median(st['warm_ms']):.1f} ms/scan (CPU backend)")
    got = {k: np.asarray(v) for k, v in mapper_gpu.state.layers.items()}
    want = {k: np.asarray(v) for k, v in mapper_cpu.state.layers.items()}
    check(compare_maps("parity map gpu-vs-cpu", got, want,
                       DECISION_LAYERS, ENVELOPE_LAYERS),
          "GPU map differs from the CPU map")
    pp_cpu, _, pw = run_postprocess(
        geom, postprocess_config(), mapper_gpu.state.layers, cpu
    )
    log(f"[parity] CPU postprocess warm {pw[0]:.1f} ms (CPU backend)")
    got, want = conditioned(pp_gpu), conditioned(pp_cpu)
    check(compare_maps("parity postprocess gpu-vs-cpu", got, want,
                       tuple(k for k in want if k not in ILL_CONDITIONED),
                       ()),
          "GPU post-processing differs from the CPU")


# slope = degrees(arccos(|normal_z|)) and roughness = sqrt(lambda_min)
# amplify last-ulp differences of their inputs without bound near flat
# ground (d arccos / dz and d sqrt / dx are unbounded at z = 1, x = 0).
# They are compared through their inputs, cos(slope) and roughness^2,
# and printed as they are.
ILL_CONDITIONED = ("slope", "roughness")


def conditioned(out):
    out = dict(out)
    out["cos(slope)"] = np.cos(np.radians(out["slope"]))
    out["roughness^2"] = np.square(out["roughness"])
    return out


def polar_field_check(check, map_m, max_range, cpu, seed=0, num_az=2048,
                      rbf=0.25):
    """polar_smeared_field on the default device vs ``cpu``: identical
    finite sets, heights within POLAR_ATOL. Returns the field shape."""
    import jax
    import jax.numpy as jnp

    import fastdem_tpu as fd
    from fastdem_tpu.postprocess.raycasting import (
        polar_dims,
        polar_smeared_field,
    )

    geom = fd.GridGeometry.from_length(map_m, map_m, 0.1)
    A, R, _ = polar_dims(geom, num_az, rbf, max_range)
    rng = np.random.default_rng(seed)
    tbl = rng.uniform(-2.0, 0.5, R * A).astype(np.float32)
    tbl[rng.random(R * A) < 0.97] = np.inf
    so = np.asarray([0.07, -0.03, 1.2], np.float32)

    def field(s, t):
        return polar_smeared_field(
            geom, s, t, num_az, rbf, max_range, exact_window=True
        )

    fn = jax.jit(field)
    dev = np.asarray(fn(jnp.asarray(so), jnp.asarray(tbl)))
    ref = np.asarray(fn(jax.device_put(so, cpu), jax.device_put(tbl, cpu)))
    if dev.shape != (R, A):
        fail(f"polar field shape {dev.shape} != {(R, A)}")
    fin = np.isfinite(ref)
    same_set = np.array_equal(fin, np.isfinite(dev))
    both = fin & np.isfinite(dev)
    dmax = float(np.max(np.abs(dev[both] - ref[both]))) if both.any() \
        else 0.0
    log(f"[parity] polar field [{R}, {A}]: finite sets equal {same_set}, "
        f"max |d| {dmax:.3g} (bound {POLAR_ATOL})")
    check(same_set, f"polar field [{R}, {A}]: finite sets differ")
    check(dmax <= POLAR_ATOL,
          f"polar field [{R}, {A}] heights differ by {dmax}")
    return R, A


# ---------------------------------------------------------------- --multi


def run_steps(step, state, stream):
    import jax.numpy as jnp

    T_bs = jnp.asarray(sensor_extrinsic())
    mask = jnp.ones(stream[0][0].shape[0], bool)
    for xyz, T_wb in stream:
        state, _ = step(state, jnp.asarray(xyz), mask, T_bs,
                        jnp.asarray(T_wb))
    return state


def phase_multi(check, devices, map_m=200.0, n_scans=20, n_points=30000,
                spread=18.0, range_max=20.0):
    """The phase-3 stream on a 2x2 mesh of ``devices`` (shard_map windowed
    and GSPMD paths) vs the one-card run; bitwise. Returns the results
    as {path: (bitwise, devices holding the layers)}."""
    import jax

    import fastdem_tpu as fd
    from fastdem_tpu.mapping.pipeline import build_integrate, create_map_state
    from fastdem_tpu.parallel import sharding as sh

    geom = fd.GridGeometry.from_length(map_m, map_m, 0.1)
    cfg = global_config(range_max)
    stream = global_stream(n_scans, n_points, spread)
    mesh = sh.make_mesh(4)
    log(f"[multi] mesh {dict(mesh.shape)} over "
        f"{[d.id for d in mesh.devices.flat]}; map {geom.shape}")
    results = {}
    for path, window_update in (("shardmap_windowed", None),
                                ("gspmd_fullmap", False)):
        with jax.default_device(devices[0]):
            one = build_integrate(geom, cfg, donate=False,
                                  window_update=window_update)
            ref = run_steps(one, create_map_state(geom, cfg), stream)
        step, shard = sh.build_sharded_integrate(
            geom, cfg, mesh, donate=False, window_update=window_update
        )
        if step.formulation != path:
            fail(f"expected the {path} path, got {step.formulation}")
        t0 = time.time()
        got = run_steps(step, shard(create_map_state(geom, cfg)), stream)
        jax.block_until_ready(got.layers)
        held = {d.id for v in got.layers.values()
                for d in v.sharding.device_set}
        same = all(
            np.array_equal(np.asarray(ref.layers[k]),
                           np.asarray(got.layers[k]), equal_nan=True)
            for k in ref.layers
        )
        differing = {
            k: diff_cells(got.layers[k], ref.layers[k], rtol=0, atol=0)
            for k in ref.layers if not np.array_equal(
                np.asarray(ref.layers[k]), np.asarray(got.layers[k]),
                equal_nan=True)
        }
        log(f"[multi] {path}: layers on devices {sorted(held)}; bitwise "
            f"equal to the one-card run: {same} "
            f"{'' if same else differing}; {time.time() - t0:.1f} s")
        results[path] = (same, held)
        check(len(held) == 4,
              f"{path}: layers sit on {len(held)} devices, not 4")
        check(same, f"{path}: sharded map differs from the one-card map")
    return results


# ---------------------------------------------------------------- main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: only the sharded global-map phase")
    ap.add_argument("--out", default=os.path.join(ROOT, "chip_smoke_out"),
                    help="directory for the node's artifacts")
    args = ap.parse_args(argv)

    # Phase 4 compares against this process's CPU backend.
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.path.insert(0, ROOT)
    import jax

    from fastdem_tpu.runtime.aotcache import enable_compile_cache

    cache = enable_compile_cache()
    log(f"[setup] compile cache {cache} ({len(os.listdir(cache))} entries "
        f"at start)")
    device, cards = phase_device(4 if args.multi else 1)
    card = cards[0]
    check = Checks()
    t_start = time.time()
    if args.multi:
        phase_multi(check, jax.devices()[:4])
    else:
        phase_node(check, args.out)
        geom, cfg, stream, mapper, pp_gpu = phase_global(check, card)
        cpu = jax.devices("cpu")[0]
        phase_goldens(check)
        phase_parity(check, geom, cfg, stream, mapper, pp_gpu, cpu)
        # The headline LOCAL field and the 20 m global window's field.
        polar_field_check(check, 15.0, 0.5 * np.hypot(15.0, 15.0) + 2.2,
                          cpu)
        polar_field_check(check, 200.0, 20.0 * 1.1 + 2.0, cpu)
    if check.failed:
        fail(f"{len(check.failed)} check(s) failed: {check.failed}")
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s; "
        f"card {card}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
