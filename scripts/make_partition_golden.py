#!/usr/bin/env python
"""Write the pod-scale partition golden file from the JAX package.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_partition_golden.py \
        [--out tests/golden/torch_partitions.json]

For each of the ten registry archs, the reference's
``repro.core.partitioner.partition_model`` at ``SHAPES["train_4k"]``, 8
stages and ``mesh_slice=64`` (the reference bench's settings) with the
methods ``compiler``, ``exact`` and ``respect`` (``RespectScheduler.
from_release()``: the release ``checkpoints/respect-v1``): each method's
assignment (one stage a graph node) and its ``bottleneck_s`` and
``latency_s`` under ``PodSystem(8)``.  ``tests/test_torch_partitioner.py``
holds the port to it on the CPU and ``chip_smoke.py`` on the card, which
imports no JAX.  Takes about ten seconds on a CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "tests" / "golden" / "torch_partitions.json"
SHAPE = "train_4k"
N_STAGES = 8
MESH_SLICE = 64
METHODS = ("compiler", "exact", "respect")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()

    from repro.configs import ARCH_IDS, SHAPES, get_config
    from repro.core import RespectScheduler
    from repro.core.partitioner import partition_model

    sched = RespectScheduler.from_release()
    archs = {}
    for arch in ARCH_IDS:
        row = {}
        for method in METHODS:
            assign, ev, g = partition_model(get_config(arch), SHAPES[SHAPE], N_STAGES,
                                            method=method, mesh_slice=MESH_SLICE,
                                            scheduler=sched if method == "respect" else None)
            row[method] = {"assignment": [int(a) for a in assign],
                           "bottleneck_s": float(ev.bottleneck_s),
                           "latency_s": float(ev.latency_s)}
        row["n_nodes"] = g.n
        archs[arch] = row
        print(arch, g.n, {m: row[m]["bottleneck_s"] for m in METHODS}, flush=True)
    out = {"meta": {"shape": SHAPE, "n_stages": N_STAGES, "mesh_slice": MESH_SLICE,
                    "system": "PodSystem(8)", "methods": list(METHODS),
                    "release_params_sha256": sched.release["params_sha256"],
                    "writer": "scripts/make_partition_golden.py (the JAX package, CPU)"},
           "archs": archs}
    args.out.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
