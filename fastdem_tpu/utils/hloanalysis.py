"""Compiled-HLO audits: measured (not narrated) communication volumes.

The sharding design's claims — per-scan integrates are collective-FREE
(scans replicated, scatters shard-local) and stencil postprocess costs
only nearest-neighbor halo bytes — are verified by parsing the compiled
program rather than asserted in prose: every
cross-device byte XLA will move appears as a collective instruction whose
result shape is statically known.
"""

from __future__ import annotations

import re
from typing import Dict

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
    "all-to-all", "collective-broadcast",
)

_OP_RE = re.compile(
    r"^(?:ROOT\s+)?[%\w.\-]+\s*=\s*(?P<shapes>.+?)\s+(?P<op>"
    + "|".join(_COLLECTIVES)
    + r")(?:-start)?\("
)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def shape_bytes(shapes_str: str) -> int:
    """Total bytes of every dtype[dims] shape in an HLO result string
    (handles tuples)."""
    total = 0
    for m in _SHAPE_RE.finditer(shapes_str):
        nbytes = _DTYPE_BYTES.get(m.group(1))
        if nbytes is None:
            continue
        count = 1
        for d in m.group(2).split(","):
            if d:
                count *= int(d)
        total += count * nbytes
    return total


def collective_bytes(hlo_text: str) -> Dict:
    """Sum the result bytes of every collective instruction in optimized
    HLO. ``-start`` async forms are counted once (their ``-done`` pair
    has no shape of its own in the `x = shape op(...)` form we match).

    Returns {"per_op": {op: bytes}, "count": n_instructions,
    "total_bytes": sum}. Byte counts are the collective RESULT sizes —
    an upper bound on the wire bytes per participating device.
    """
    per_op: Dict[str, int] = {}
    count = 0
    for line in hlo_text.splitlines():
        m = _OP_RE.match(line.strip())
        if not m:
            continue
        op = m.group("op")
        b = shape_bytes(m.group("shapes"))
        per_op[op] = per_op.get(op, 0) + b
        count += 1
    return {
        "per_op": per_op,
        "count": count,
        "total_bytes": sum(per_op.values()),
    }


def compiled_collective_bytes(jitted, *args, **kwargs) -> Dict:
    """Lower+compile a jitted callable on the given args and audit its
    collectives. Reuses the in-process executable cache when the program
    was already compiled."""
    compiled = jitted.lower(*args, **kwargs).compile()
    return collective_bytes(compiled.as_text())
