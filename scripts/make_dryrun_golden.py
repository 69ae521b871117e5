#!/usr/bin/env python
"""Write the dry run's golden file from the JAX package.

    JAX_PLATFORMS=cpu python scripts/make_dryrun_golden.py \
        [--out tests/golden/torch_dryrun.json] [--cells arch:shape:mesh,...]

For each golden cell, the reference's ``repro.launch.dryrun.lower_cell``
on 512 host placeholder devices: per device, ``memory_analysis()``'s
argument, output and temp bytes, ``analyze_hlo``'s flops, bytes and
collectives by kind, and ``analytic_flops``, with the lower and compile
seconds.  Train cells are lowered without activation recompute
(``build_model(cfg, remat=False)``, ``TrainConfig(microbatches=
MICROBATCHES[arch], master_fp32=False)``), the step the port describes;
the default lowering (remat on) is recorded beside it under
``"remat_default"`` for display.  Each cell also records the shapes and
partition specs XLA chose for the step's outputs (``"outputs"``).

``tests/test_torch_dryrun.py`` holds ``repro_torch.launch.dryrun`` to this
file on the CPU and ``chip_smoke.py`` on the card, which imports no JAX.
A full-size cell compiles for one to several minutes and takes a few GiB
of host memory; the file is rewritten only by this script.
"""

from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "tests" / "golden" / "torch_dryrun.json"

# (arch, shape, mesh): one cell of each kind, an MoE arch, a hybrid SSM arch
# at 512k and one cell on the multi-pod mesh
CELLS = (
    ("internlm2-1.8b", "train_4k", "single"),
    ("internlm2-1.8b", "prefill_32k", "single"),
    ("internlm2-1.8b", "decode_32k", "single"),
    ("qwen3-moe-235b-a22b", "decode_32k", "single"),
    ("zamba2-7b", "long_500k", "single"),
    ("internlm2-1.8b", "train_4k", "multi"),
)


def _spec(sharding) -> list | str:
    spec = getattr(sharding, "spec", None)
    if spec is None:
        return str(sharding)
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def lower(arch: str, shape: str, mesh: str, remat: bool) -> dict:
    import jax
    from repro.launch import dryrun
    from repro.models.model import build_model

    captured = []
    compile_ = jax.stages.Lowered.compile

    def capture(self, *a, **kw):
        out = compile_(self, *a, **kw)
        captured.append((self, out))
        return out

    saved = dryrun.build_model, dryrun.train_config
    if not remat:
        dryrun.build_model = functools.partial(build_model, remat=False)
        dryrun.train_config = lambda a: dryrun.TrainConfig(
            microbatches=dryrun.MICROBATCHES.get(a, 8), master_fp32=False, remat=False)
    jax.stages.Lowered.compile = capture
    try:
        rec = dryrun.lower_cell(arch, shape, mesh == "multi")
    finally:
        dryrun.build_model, dryrun.train_config = saved
        jax.stages.Lowered.compile = compile_
    if rec["status"] != "ok":
        return rec
    from repro.configs import SHAPES, get_config
    from repro.models.model import analytic_flops
    lowered, compiled = captured[-1]
    outs = [{"shape": list(o.shape), "dtype": str(o.dtype), "spec": _spec(s)}
            for o, s in zip(jax.tree_util.tree_leaves(lowered.out_info),
                            jax.tree_util.tree_leaves(compiled.output_shardings))]
    return {"arch": arch, "shape": shape, "mesh": mesh, "chips": rec["chips"],
            "memory": rec["memory"], "hlo_cost": rec["hlo_cost"],
            "model_flops": analytic_flops(get_config(arch), SHAPES[shape]),
            "roofline_tpu_v5e": rec["roofline"], "timing": rec["timing"], "outputs": outs}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("--cells", default=None,
                    help="comma-separated arch:shape:mesh (default: the golden cells)")
    args = ap.parse_args()
    cells = CELLS if args.cells is None else tuple(
        tuple(c.split(":")) for c in args.cells.split(","))

    import jax
    out = {"jax": jax.__version__, "devices": jax.device_count(),
           "note": ("reference lowering on host placeholder devices; train cells without "
                    "remat (remat_default: the reference's default lowering)"),
           "cells": {}}
    for arch, shape, mesh in cells:
        t0 = time.perf_counter()
        rec = lower(arch, shape, mesh, remat=False)
        if shape == "train_4k" and rec.get("status", "ok") == "ok":
            d = lower(arch, shape, mesh, remat=True)
            rec["remat_default"] = {k: d[k] for k in ("memory", "hlo_cost", "timing")}
        out["cells"][f"{arch}__{shape}__{mesh}"] = rec
        print(f"{arch} {shape} {mesh}: {time.perf_counter() - t0:.1f} s "
              f"(compile {rec.get('timing', {}).get('compile_s', float('nan')):.1f} s)",
              flush=True)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
