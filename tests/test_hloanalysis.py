"""Collective-bytes audit (utils/hloanalysis.py): communication numbers
measured from compiled programs, not narrated."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fastdem_tpu.utils import hloanalysis as ha


def test_shape_bytes():
    assert ha.shape_bytes("f32[160,160]{1,0}") == 160 * 160 * 4
    assert ha.shape_bytes("(f32[8], s32[4])") == 8 * 4 + 4 * 4
    assert ha.shape_bytes("bf16[2,3]") == 12
    assert ha.shape_bytes("pred[]") == 1  # no dims -> one element
    assert ha.shape_bytes("token[]") == 0  # unknown dtype ignored


def test_collective_bytes_parses_hlo_text():
    txt = """
  %x.1 = f32[160,163]{1,0} collective-permute(%a), source_target_pairs={{0,1}}
  %y = f32[8,8]{1,0} all-reduce(%b), replica_groups={}
  %fusion.all-reduce-ish = f32[4]{0} add(%c, %d)
  %z = (f32[16], f32[16]) all-gather-start(%e), dimensions={0}
"""
    out = ha.collective_bytes(txt)
    assert out["per_op"]["collective-permute"] == 160 * 163 * 4
    assert out["per_op"]["all-reduce"] == 8 * 8 * 4
    assert out["per_op"]["all-gather"] == 2 * 16 * 4
    assert out["count"] == 3  # the add() fusion must NOT match
    assert out["total_bytes"] == sum(out["per_op"].values())


def test_compiled_audit_sharded_stencil():
    """A sharded 1-cell-halo stencil must show collective-permute bytes;
    a replicated elementwise program must show none."""
    if jax.device_count() < 2:
        pytest.skip("needs the 8-device CPU mesh")
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = np.array(jax.devices()[:2]).reshape(2, 1)
    mesh = Mesh(devs, ("x", "y"))
    sh = NamedSharding(mesh, P("x", "y"))
    arr = jax.device_put(jnp.ones((64, 64), jnp.float32), sh)

    @jax.jit
    def stencil(a):
        return a + jnp.roll(a, 1, axis=0) + jnp.roll(a, -1, axis=0)

    audit = ha.compiled_collective_bytes(stencil, arr)
    assert audit["total_bytes"] > 0

    @jax.jit
    def elementwise(a):
        return a * 2.0 + 1.0

    audit2 = ha.compiled_collective_bytes(elementwise, arr)
    assert audit2["total_bytes"] == 0
