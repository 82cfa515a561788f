"""The YAML subset loader (config/yamlsubset.py) against PyYAML on every
preset, and node configs loading with PyYAML unavailable."""

import glob
import math
import os
import sys

import pytest

from fastdem_tpu.config import yamlsubset
from fastdem_tpu.runtime.node_config import NodeConfig

PRESETS = sorted(
    glob.glob(
        os.path.join(
            os.path.dirname(__file__), "..", "fastdem_tpu", "config",
            "presets", "*.yaml",
        )
    )
)
IDS = [os.path.basename(p) for p in PRESETS]


def test_presets_found():
    assert len(PRESETS) == 6


@pytest.mark.parametrize("path", PRESETS, ids=IDS)
def test_subset_matches_pyyaml(path):
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        text = f.read()
    assert yamlsubset.safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", PRESETS, ids=IDS)
def test_node_config_loads_without_pyyaml(path, monkeypatch):
    """What tools/fastdem_node.py does at start-up, with PyYAML blocked
    from import: same NodeConfig as with it."""
    with_yaml = NodeConfig.load(path)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError):
        import yaml  # noqa: F401
    assert NodeConfig.load(path) == with_yaml


def test_scalars_and_flow_lists():
    text = (
        "a: [1, \"x, y\", 'it''s', 2.5, .inf, ~, yes]  # trailing\n"
        "b:\n"
        "  c: \"q # kept\"\n"
        "  d: 1e-4\n"
        "  e: -0.0001\n"
        "  f:\n"
        "g: []\n"
    )
    got = yamlsubset.safe_load(text)
    assert got["a"][:3] == [1, "x, y", "it's"]
    assert got["a"][3] == 2.5 and math.isinf(got["a"][4])
    assert got["a"][5] is None and got["a"][6] is True
    # YAML 1.1: an exponent without a dot is a string, as in PyYAML.
    assert got["b"] == {"c": "q # kept", "d": "1e-4", "e": -0.0001,
                        "f": None}
    assert got["g"] == []


@pytest.mark.parametrize(
    "text",
    ["a:\n  - 1\n", "a: &x 1\n", "a: 1\n  b: 2\n", "a: 1\na: 2\n",
     "a: [1, [2]]\n"],
    ids=["block_seq", "anchor", "bad_indent", "dup_key", "nested_flow"],
)
def test_unsupported_yaml_raises(text):
    with pytest.raises(ValueError):
        yamlsubset.safe_load(text)
