"""Compile cache: where JAX keeps compiled programs, and deployable
program-cache bundles.

:func:`enable_compile_cache` is the one place this repository turns on
JAX's persistent compilation cache. ``JAX_COMPILATION_CACHE_DIR``, when
set, stands as JAX reads it; otherwise the cache lives at the fixed path
``<checkout>/.jax_cache`` (a fixed path, because the path is part of every
cache key: a directory that moves never hits).

The reference node is ready in milliseconds after process start
(/root/reference/ros2/src/fastdem_ros_node.cpp — plain C++), while a JAX
pipeline pays XLA compilation on first run. ``jax.export`` does not help —
it serializes StableHLO and skips only *tracing*; the expensive step is
the backend compile. What skips the backend compile is JAX's persistent
compilation cache, which stores the compiled EXECUTABLE keyed by
(optimized program, compile options, compiler version).

This module turns that cache into a first-class deployable artifact:

  * a *bundle* is a directory of cache entries + ``manifest.json``
    fingerprinting the config/geometry/capacities and the toolchain it
    was built with — ship it next to a checkpoint and a node on the same
    backend starts without recompiling;
  * :func:`warmup` populates a bundle by compiling through EXACTLY the
    code paths the node/replay use (facade buckets, postprocess chain,
    batched replay), so cache keys are guaranteed to match;
  * :func:`enable` activates a bundle for this process (call before the
    first compile) and surfaces manifest drift as warnings instead of a
    silent recompile.

Invalidation rule: the cache key includes the backend's compiler version,
so entries built by another jax/jaxlib or for another device miss and the
programs recompile (correct, but cold). The manifest records jax version,
platform, and device kind; :func:`verify` reports which of those moved. A
canary fingerprint (optional, `canary=True` at warmup) additionally
detects compiler drift the version strings do not show, by recompiling
one small program and comparing its executable fingerprint.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from dataclasses import asdict, is_dataclass
from typing import Optional, Sequence

log = logging.getLogger("fastdem_tpu.aotcache")

MANIFEST = "manifest.json"
_MIN_COMPILE_SECS = 0.5


def _canonical(obj):
    """Config/geometry -> stable JSON-able structure."""
    if is_dataclass(obj) and not isinstance(obj, type):
        return {k: _canonical(v) for k, v in asdict(obj).items()}
    if isinstance(obj, dict):
        return {str(k): _canonical(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    if hasattr(obj, "value"):  # enums
        return obj.value
    if isinstance(obj, float):
        return round(obj, 12)
    return obj


def fingerprint(geom, cfg, pp_cfg=None, capacities: Sequence[int] = ()) -> str:
    """Stable hash of everything that shapes the compiled programs."""
    payload = {
        "geometry": {
            "shape": list(geom.shape),
            "resolution": geom.resolution,
        },
        "config": _canonical(cfg),
        "postprocess": _canonical(pp_cfg) if pp_cfg is not None else None,
        "capacities": sorted(int(c) for c in capacities),
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _toolchain() -> dict:
    import jax

    dev = jax.devices()[0]
    return {
        "jax": jax.__version__,
        "platform": dev.platform,
        "device_kind": getattr(dev, "device_kind", "unknown"),
    }


def _canary_fingerprint() -> str:
    """Compile one small fixed program and fingerprint its executable —
    detects backend-compiler drift that the version strings don't show."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def canary(x):
        return jnp.tanh(x @ x.T).sum()

    compiled = canary.lower(jnp.ones((128, 128), jnp.float32)).compile()
    try:
        txt = compiled.as_text()
    except Exception:  # noqa: BLE001 — backend may not expose it
        return "unavailable"
    return hashlib.sha256(txt.encode()).hexdigest()[:16]


ENV_CACHE_DIR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache``: the cache directory when the environment
    names none (listed in .gitignore)."""
    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(root, ".jax_cache")


def enable_compile_cache(bundle_dir: Optional[str] = None) -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    Call BEFORE the first jit/compile. With ``JAX_COMPILATION_CACHE_DIR``
    set, JAX's own setting stands and no other directory is set; a
    ``bundle_dir`` naming a different directory is then an error (the
    caller asked for two caches). Without it, the cache goes to
    ``bundle_dir`` if given, else to :func:`default_cache_dir`.
    """
    import jax

    env = os.environ.get(ENV_CACHE_DIR)
    if env:
        if bundle_dir is not None and (
            os.path.realpath(bundle_dir) != os.path.realpath(env)
        ):
            raise RuntimeError(
                f"{ENV_CACHE_DIR}={env} and the program-cache bundle "
                f"{bundle_dir} name different directories; unset one"
            )
        cache_dir = env
    else:
        cache_dir = bundle_dir or default_cache_dir()
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", _MIN_COMPILE_SECS
    )
    return cache_dir


def enable(bundle_dir: str, create: bool = True) -> Optional[dict]:
    """Point this process's persistent compilation cache at ``bundle_dir``.

    Call BEFORE the first jit/compile. Raises RuntimeError when
    ``JAX_COMPILATION_CACHE_DIR`` names another directory. Returns the
    bundle manifest (None if absent) after logging any toolchain drift —
    drifted entries are not an error, they just miss and recompile."""
    if create:
        os.makedirs(bundle_dir, exist_ok=True)
    enable_compile_cache(bundle_dir)
    manifest = read_manifest(bundle_dir)
    if manifest is not None:
        for key, cur in _toolchain().items():
            built = manifest.get("toolchain", {}).get(key)
            if built is not None and built != cur:
                log.warning(
                    "program-cache bundle %s was built with %s=%s but this "
                    "process has %s — entries will miss and recompile",
                    bundle_dir, key, built, cur,
                )
    return manifest


def read_manifest(bundle_dir: str) -> Optional[dict]:
    path = os.path.join(bundle_dir, MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def verify(bundle_dir: str, canary: bool = False) -> dict:
    """Report bundle health: entry count, toolchain drift, optionally the
    canary recompile check (costs one small backend compile)."""
    manifest = read_manifest(bundle_dir) or {}
    entries = [
        f for f in os.listdir(bundle_dir) if f != MANIFEST
    ] if os.path.isdir(bundle_dir) else []
    drift = {}
    for key, cur in _toolchain().items():
        built = manifest.get("toolchain", {}).get(key)
        if built is not None and built != cur:
            drift[key] = {"built": built, "current": cur}
    out = {
        "bundle": bundle_dir,
        "entries": len(entries),
        "fingerprint": manifest.get("fingerprint"),
        "toolchain_drift": drift,
    }
    if canary and manifest.get("canary"):
        cur = _canary_fingerprint()
        out["canary_match"] = cur == manifest["canary"]
        if not out["canary_match"]:
            log.warning(
                "backend compiler drifted since the bundle was built "
                "(canary %s -> %s): compiled entries will miss",
                manifest["canary"], cur,
            )
    return out


def warmup(
    geom,
    cfg,
    pp_cfg=None,
    bundle_dir: Optional[str] = None,
    capacities: Sequence[int] = (32768,),
    replay_batches: Sequence[int] = (),
    canary: bool = False,
    progress=None,
) -> dict:
    """Compile the node's programs into the active (or given) bundle.

    Drives the REAL code paths — ``FastDEM.integrate`` per capacity
    bucket, the postprocess chain, and ``integrate_sequence`` for each
    replay batch size — so the persistent-cache keys match what the
    node/replay will request. Returns the manifest (also written to the
    bundle)."""
    import numpy as np

    if bundle_dir is not None:
        enable(bundle_dir)
    t0 = time.time()
    say = progress or (lambda msg: log.info("%s", msg))

    from fastdem_tpu.cloud.pointcloud import from_numpy
    from fastdem_tpu.config.config import PostProcessConfig
    from fastdem_tpu.mapping.pipeline import FastDEM
    from fastdem_tpu.postprocess import apply_postprocess_fn

    import jax

    compiled = []
    mapper = FastDEM(geom, cfg)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    rng = np.random.default_rng(0)
    for cap in capacities:
        n = int(cap)
        say(f"compiling integrate @ capacity {n} ...")
        xyz = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
        xyz[:, 2] = -1.0
        mapper.integrate(
            from_numpy(xyz, frame_id="lidar"), T_bs,
            np.eye(4, dtype=np.float32),
        )
        compiled.append({"program": "integrate", "capacity": n})
        for b in replay_batches:
            say(f"compiling integrate_sequence @ cap {n} batch {b} ...")
            clouds = [
                from_numpy(xyz, frame_id="lidar") for _ in range(int(b))
            ]
            poses = np.tile(
                np.eye(4, dtype=np.float32), (int(b), 1, 1)
            )
            mapper.integrate_sequence(clouds, T_bs, poses, batch=int(b))
            compiled.append(
                {"program": "integrate_sequence", "capacity": n,
                 "batch": int(b)}
            )
        mapper.reset()
    pp = pp_cfg or PostProcessConfig()
    say("compiling postprocess chain ...")
    fn = jax.jit(apply_postprocess_fn(geom, pp))
    e = mapper.state.layers["elevation"]
    jax.block_until_ready(
        jax.tree_util.tree_leaves(fn(e, e + 0.1, e - 0.1))
    )
    compiled.append({"program": "postprocess"})

    manifest = {
        "fingerprint": fingerprint(geom, cfg, pp, capacities),
        "toolchain": _toolchain(),
        "capacities": [int(c) for c in capacities],
        "replay_batches": [int(b) for b in replay_batches],
        "programs": compiled,
        "warmup_seconds": round(time.time() - t0, 1),
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    if canary:
        say("compiling canary probe ...")
        manifest["canary"] = _canary_fingerprint()
    bundle = jax.config.jax_compilation_cache_dir
    if bundle:
        with open(os.path.join(bundle, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2)
            f.write("\n")
    return manifest
