"""Program-cache bundles (runtime/aotcache.py): the cold-start story.

Reference behavior being re-provided: the C++ node is compute-ready at
process start (ros2/src/fastdem_ros_node.cpp); here the compiled XLA
executables ship as a cache bundle so a restarted node skips first-run
compiles. These tests run on the CPU backend (conftest) — the mechanism
(persistent compilation cache + manifest) is backend-agnostic.
"""

import json
import os

import numpy as np
import pytest

from fastdem_tpu.config.config import Config, PostProcessConfig
from fastdem_tpu.grid.geometry import GridGeometry
from fastdem_tpu.runtime import aotcache


@pytest.fixture()
def geom():
    return GridGeometry.from_length(6.0, 6.0, 0.1)


@pytest.fixture(autouse=True)
def no_env_cache(monkeypatch):
    """Bundles are explicit here; an outer JAX_COMPILATION_CACHE_DIR would
    (rightly) conflict with them."""
    monkeypatch.delenv(aotcache.ENV_CACHE_DIR, raising=False)


@pytest.fixture
def restore_cache_dir():
    import jax

    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_warmup_populates_bundle_and_manifest(tmp_path, geom):
    bundle = str(tmp_path / "bundle")
    cfg = Config()
    manifest = aotcache.warmup(
        geom, cfg, PostProcessConfig(), bundle_dir=bundle,
        capacities=(4096,), replay_batches=(2,),
    )
    assert os.path.exists(os.path.join(bundle, aotcache.MANIFEST))
    progs = {p["program"] for p in manifest["programs"]}
    assert progs == {"integrate", "integrate_sequence", "postprocess"}
    assert manifest["warmup_seconds"] > 0
    # Cache entries were actually written (at least one compile > 0.5 s
    # would be needed; on fast CPU compiles entries may be few, but the
    # manifest must round-trip regardless).
    health = aotcache.verify(bundle)
    assert health["fingerprint"] == manifest["fingerprint"]
    assert health["toolchain_drift"] == {}


def test_enable_warns_on_toolchain_drift(tmp_path, geom, caplog):
    bundle = str(tmp_path / "bundle")
    os.makedirs(bundle)
    manifest = {
        "fingerprint": "abc",
        "toolchain": {"jax": "0.0.1", "platform": "tpu",
                      "device_kind": "v99"},
    }
    with open(os.path.join(bundle, aotcache.MANIFEST), "w") as f:
        json.dump(manifest, f)
    with caplog.at_level("WARNING", logger="fastdem_tpu.aotcache"):
        out = aotcache.enable(bundle)
    assert out["fingerprint"] == "abc"
    assert any("will miss and recompile" in r.message for r in caplog.records)
    health = aotcache.verify(bundle)
    assert set(health["toolchain_drift"]) >= {"jax", "platform"}


def test_fingerprint_sensitivity(geom):
    cfg = Config()
    fp1 = aotcache.fingerprint(geom, cfg, None, (4096,))
    assert fp1 == aotcache.fingerprint(geom, cfg, None, (4096,))
    cfg2 = Config()
    cfg2.mapping.kalman.process_noise = cfg2.mapping.kalman.process_noise + 1e-3
    assert fp1 != aotcache.fingerprint(geom, cfg2, None, (4096,))
    assert fp1 != aotcache.fingerprint(geom, cfg, None, (8192,))
    geom2 = GridGeometry.from_length(8.0, 6.0, 0.1)
    assert fp1 != aotcache.fingerprint(geom2, cfg, None, (4096,))


def test_cache_dir_from_env_stands(tmp_path, monkeypatch, restore_cache_dir):
    """JAX_COMPILATION_CACHE_DIR set: JAX's own setting stands and the
    helper sets no other directory."""
    import jax

    env_dir = str(tmp_path / "env_cache")
    monkeypatch.setenv(aotcache.ENV_CACHE_DIR, env_dir)
    before = jax.config.jax_compilation_cache_dir
    assert aotcache.enable_compile_cache() == env_dir
    assert jax.config.jax_compilation_cache_dir == before
    # Naming the same directory as a bundle is no conflict.
    assert aotcache.enable_compile_cache(env_dir) == env_dir


def test_cache_dir_default_is_fixed_path_in_checkout(restore_cache_dir):
    import jax

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    got = aotcache.enable_compile_cache()
    assert got == os.path.join(repo, ".jax_cache") == aotcache.default_cache_dir()
    assert jax.config.jax_compilation_cache_dir == got
    assert os.path.isdir(got)


def test_env_and_conflicting_bundle_stop(tmp_path, monkeypatch,
                                         restore_cache_dir):
    monkeypatch.setenv(aotcache.ENV_CACHE_DIR, str(tmp_path / "env_cache"))
    with pytest.raises(RuntimeError, match="different directories"):
        aotcache.enable(str(tmp_path / "bundle"))
