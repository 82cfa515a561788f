#!/usr/bin/env python
"""Build a program-cache bundle for a node config (the cold-start story).

Compiles the integrate / postprocess / replay programs a node with this
config will request into a deployable cache directory
(fastdem_tpu/runtime/aotcache.py). Ship the bundle next to a checkpoint;
`fastdem_node --program-cache DIR` then starts without paying first-run
XLA compiles (reference node readiness:
/root/reference/ros2/src/fastdem_ros_node.cpp).

Usage:
  python tools/aot_warmup.py --config fastdem_tpu/config/presets/\
local_mapping.yaml --bundle /path/bundle [--capacities 32768,65536]
  python tools/aot_warmup.py --verify /path/bundle [--canary]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None,
                    help="node config YAML (fastdem_tpu/config/presets/*)")
    ap.add_argument("--bundle", default=None, metavar="DIR")
    ap.add_argument("--capacities", default="32768",
                    help="comma-separated point capacities to compile")
    ap.add_argument("--replay-batches", default="",
                    help="comma-separated integrate_sequence batch sizes")
    ap.add_argument("--canary", action="store_true",
                    help="record a canary executable fingerprint "
                         "(detects backend-compiler drift at verify time)")
    ap.add_argument("--verify", default=None, metavar="DIR",
                    help="report bundle health instead of building")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from fastdem_tpu.runtime import aotcache

    if args.verify:
        print(json.dumps(
            aotcache.verify(args.verify, canary=args.canary), indent=2
        ))
        return 0

    if not (args.config and args.bundle):
        ap.error("--config and --bundle are required (or use --verify)")

    from fastdem_tpu.runtime.node_config import NodeConfig

    from fastdem_tpu.grid.geometry import GridGeometry

    cfg = NodeConfig.load(args.config)
    geom = GridGeometry.from_length(
        cfg.map.width, cfg.map.height, cfg.map.resolution
    )
    caps = [int(c) for c in args.capacities.split(",") if c]
    batches = [int(b) for b in args.replay_batches.split(",") if b]
    manifest = aotcache.warmup(
        geom, cfg.pipeline, cfg.postprocess,
        bundle_dir=args.bundle, capacities=caps, replay_batches=batches,
        canary=args.canary, progress=lambda m: print(m, file=sys.stderr),
    )
    print(json.dumps(manifest, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
