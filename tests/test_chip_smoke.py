"""chip_smoke.py off the GPU: it must refuse to report, and its phases'
logic (streams, comparisons, the sharded-vs-one-card check) runs here at
a tiny size on CPU devices standing in for the card."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TINY = dict(map_m=40.0, n_scans=3, n_points=4000, spread=9.0, range_max=8.0)


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_diff_cells_semantics():
    a = np.asarray([1.0, np.nan, np.inf, 2.0, 5.0], np.float32)
    b = np.asarray([1.0 + 1e-7, np.nan, np.inf, np.nan, 5.1], np.float32)
    n, dmax = cs.diff_cells(a, b)
    assert n == 2  # NaN-mask mismatch + the 0.1 difference
    assert dmax == pytest.approx(0.1, rel=1e-5)


def test_compare_maps_ghost_clear_cells_are_envelope():
    """A cell whose ghost-clear decision differs is NaN in every layer on
    one side: counted in the envelope, not against the decision layers."""
    shape = (100, 100)
    want = {"elevation": np.zeros(shape, np.float32),
            "ghost_removal": np.full(shape, np.nan, np.float32)}
    got = {k: v.copy() for k, v in want.items()}
    got["elevation"][3, 4] = np.nan
    got["ghost_removal"][3, 4] = 1.0
    assert cs.compare_maps("t", got, want, ("elevation",), ())
    got["elevation"][5, 5] = 1.0  # a real difference still fails
    assert not cs.compare_maps("t", got, want, ("elevation",), ())


def test_global_phase_and_parity_tiny():
    check = cs.Checks()
    geom, cfg, stream, mapper, pp = cs.phase_global(check, "cpu", **TINY)
    assert len(stream) == TINY["n_scans"]
    assert geom.shape == (400, 400)
    cs.phase_parity(check, geom, cfg, stream, mapper, pp,
                    jax.devices("cpu")[1])
    assert check.failed == []


def test_polar_field_check_tiny():
    check = cs.Checks()
    R, A = cs.polar_field_check(check, 6.0, 5.0, jax.devices("cpu")[1])
    assert A == 2048 and R > 0
    assert check.failed == []


def test_multi_phase_on_four_cpu_devices():
    """The --multi path on four virtual devices: both sharded paths hold
    the layers on four devices and equal the one-card map bitwise."""
    check = cs.Checks()
    res = cs.phase_multi(check, jax.devices()[:4], **TINY)
    assert set(res) == {"shardmap_windowed", "gspmd_fullmap"}
    for same, held in res.values():
        assert same and len(held) == 4
    assert check.failed == []


@pytest.mark.gpu
def test_polar_field_on_gpu(gpu_device):
    """On a card: the polar field on the GPU vs the CPU backend."""
    check = cs.Checks()
    with jax.default_device(gpu_device):
        cs.polar_field_check(check, 15.0, 0.5 * np.hypot(15.0, 15.0) + 2.2,
                             jax.devices("cpu")[0])
    assert check.failed == []
