#!/usr/bin/env python
"""Write the example scripts' golden file from the JAX package.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_edge_deploy_golden.py \
        [--out tests/golden/torch_edge_deploy.json]

Runs the loops of ``examples/edge_pipeline_deploy.py`` and
``examples/quickstart.py`` with the reference's untrained agent
(``RespectScheduler.init(seed=0)``, hidden 256; the examples' default where
``artifacts/respect_agent.npz`` is absent) and the pool of
``examples/serve_traffic.py``:

* ``deploy``: for each Table-I model and k in (4, 5, 6) on
  ``EDGETPU.with_stages(k)``, the compiler emulation's, the exact solver's
  and RESPECT's assignment sha256 (int64 bytes), ``bottleneck_s`` and
  whether the assignment is monotone;
* ``quickstart``: ResNet50 at k = 4, the same three records and RESPECT's
  per-stage ops, parameter bytes and over-cache flags;
* ``serve_traffic``: the eight ``sample_dag`` graphs drawn from
  ``default_rng(0)`` and ResNet50, scheduled at k = 4 by
  ``RespectScheduler.init(seed=0, hidden=64)`` (each assignment in full).

Timing fields are left out.  ``tests/test_torch_examples.py`` holds the
port's twins (``repro_torch.edge_pipeline_deploy``, ``quickstart``,
``serve_traffic``) to it on the CPU and ``chip_smoke.py`` on the card, which
imports no JAX.  Takes about a minute on a CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "tests" / "golden" / "torch_edge_deploy.json"
DEPTHS = (4, 5, 6)
QUICKSTART = ("ResNet50", 4)
SERVE_HIDDEN, SERVE_STAGES = 64, 4


def sha(a) -> str:
    return hashlib.sha256(np.asarray(a, dtype=np.int64).tobytes()).hexdigest()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()

    from repro.core import (EDGETPU, MODEL_SPECS, RespectScheduler, build_model_graph,
                            compiler_partition, evaluate_schedule, exact_dp, sample_dag,
                            validate_monotone)

    sched = RespectScheduler.init(seed=0)

    def records(g, k, sys_):
        res = sched.schedule(g, k, sys_)
        a_e, _ = exact_dp(g, k, sys_)
        out = {}
        for method, a in (("compiler", compiler_partition(g, k, sys_)), ("exact", a_e),
                          ("respect", res.assignment)):
            out[method] = {"assign_sha256": sha(a),
                           "bottleneck_s": float(evaluate_schedule(g, a, sys_).bottleneck_s),
                           "monotone": bool(validate_monotone(g, a, k))}
        return out, res.assignment

    deploy = []
    for name in MODEL_SPECS:
        g = build_model_graph(name)
        for k in DEPTHS:
            rec, _ = records(g, k, EDGETPU.with_stages(k))
            deploy.append({"model": name, "k": k, "n": g.n, **rec})
            print(name, k, {m: rec[m]["bottleneck_s"] for m in rec}, flush=True)

    name, k = QUICKSTART
    g = build_model_graph(name)
    sys_ = EDGETPU.with_stages(k)
    rec, a_rl = records(g, k, sys_)
    ev = evaluate_schedule(g, a_rl, sys_)
    quick = {"model": name, "stages": k, "n": g.n, "max_in_degree": int(g.max_in_degree),
             "depth": int(g.depth), "param_bytes": float(g.param_bytes.sum()), **rec,
             "placement": [{"stage": s, "ops": int((a_rl == s).sum()),
                            "param_bytes": float(ev.stage_params[s]),
                            "over_cache": bool(ev.off_cache_bytes[s] > 0)} for s in range(k)]}

    rng = np.random.default_rng(0)
    pool = [sample_dag(rng, n=int(rng.integers(10, 33)), deg=3) for _ in range(8)]
    pool.append(build_model_graph("ResNet50"))
    small = RespectScheduler.init(seed=0, hidden=SERVE_HIDDEN)
    served = small.schedule_many(pool, SERVE_STAGES)
    serve = {"hidden": SERVE_HIDDEN, "stages": SERVE_STAGES,
             "pool": [{"model": g.model_name, "n": g.n,
                       "assignment": [int(x) for x in r.assignment]}
                      for g, r in zip(pool, served)]}

    out = {"meta": {"agent": "RespectScheduler.init(seed=0)", "hidden": sched.hidden,
                    "depths": list(DEPTHS), "system": "EDGETPU.with_stages(k)",
                    "digest": "sha256 of the assignment as int64 bytes",
                    "writer": "scripts/make_edge_deploy_golden.py (the JAX package, CPU)"},
           "deploy": deploy, "quickstart": quick, "serve_traffic": serve}
    args.out.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
