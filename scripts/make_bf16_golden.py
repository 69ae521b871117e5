#!/usr/bin/env python
"""Write the bf16-decode golden file from the JAX package.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_bf16_golden.py \
        [--out tests/golden/torch_bf16_schedules.json]

Every schedule in the file comes from the reference (``repro``) on the CPU,
through ``RespectScheduler(decode_impl="kernel-interpret",
decode_bf16=True)``: the whole-decode Pallas kernel in interpret mode with
its operands stored in bfloat16 (``C``, ``C @ W_ref`` of both heads,
``emb``, and every decoder weight but the bias), summed in float32.

* ``table1`` — order and assignment digests (sha256 of int64 bytes) of the
  release ``respect-v1`` on the ten Table-I graphs at k = 4 (in the order
  of ``tests/golden/dnn_schedules.json``), with each graph's bucket;
* ``table1_differs_from_f32`` — the Table-I graphs whose bf16 order (or
  assignment) differs from the float32 golden file's;
* ``synthetic`` — digests on ``sample_batch(default_rng(0), 64, n=30)``
  under ``respect-v1`` (hidden 128) and under ``init(seed=0)`` (hidden
  256), each with the indices whose order differs from the same
  scheduler's float32 kernel.

The port's tests and ``chip_smoke.py`` read the file as data
(``chip_smoke.py`` may not import JAX); ``tests/test_torch_decode_bf16.py``
re-derives the Table-I graphs of buckets 256 and 512 from JAX, so the file
cannot drift from the reference.  Takes about 30 s on an 8-core CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "tests" / "golden" / "torch_bf16_schedules.json"
DNN_GOLDEN = ROOT / "tests" / "golden" / "dnn_schedules.json"
IMPL = "kernel-interpret"
SEED = 0
N_STAGES = 4
N_SYNTH = 64


def digest(arr) -> str:
    import numpy as np
    return hashlib.sha256(np.asarray(arr, dtype=np.int64).tobytes()).hexdigest()


def table1_names() -> list[str]:
    return list(json.loads(DNN_GOLDEN.read_text())["models"])


def table1():
    from repro.core import build_model_graph
    return [build_model_graph(nm) for nm in table1_names()]


def synthetic():
    import numpy as np
    from repro.core import sample_batch
    return sample_batch(np.random.default_rng(0), N_SYNTH, n=30)


def release(bf16: bool):
    from repro.core import RespectScheduler
    sched = RespectScheduler.from_release(decode_impl=IMPL, decode_bf16=bf16)
    if sched.release is None:
        raise SystemExit("checkpoints/respect-v1 did not load")
    return sched


def seeded(bf16: bool):
    from repro.core import RespectScheduler
    return RespectScheduler.init(seed=SEED, decode_impl=IMPL, decode_bf16=bf16)


def schedule(sched, graphs) -> dict:
    res = sched.schedule_many(graphs, N_STAGES, use_cache=False)
    return {"order_sha256": [digest(r["order"]) for r in res],
            "assign_sha256": [digest(r["assignment"]) for r in res]}


def build_payload() -> dict:
    from repro.core.batching import bucket_for
    names, t1, synth = table1_names(), table1(), synthetic()
    f32 = json.loads(DNN_GOLDEN.read_text())["models"]
    rel = release(True)
    got = schedule(rel, t1)
    t1_out = {nm: {"bucket": bucket_for(g.n), "order_sha256": o, "assign_sha256": a}
              for nm, g, o, a in zip(names, t1, got["order_sha256"], got["assign_sha256"])}
    synth_out = {}
    for label, make in (("respect-v1", release), ("init_seed0", seeded)):
        bf, fl = schedule(make(True), synth), schedule(make(False), synth)
        bf["orders_differ_from_f32"] = [i for i, (a, b) in enumerate(
            zip(bf["order_sha256"], fl["order_sha256"])) if a != b]
        synth_out[label] = bf
    return {
        "meta": {
            "generator": "scripts/make_bf16_golden.py (the JAX package, on the CPU)",
            "scheduler": f"RespectScheduler(decode_impl={IMPL!r}, decode_bf16=True)",
            "n_stages": N_STAGES, "max_deg": rel.max_deg,
            "synthetic": f"sample_batch(default_rng(0), {N_SYNTH}, n=30)",
            "hidden": {"respect-v1": int(rel.params["dec0"].shape[-1]),
                       "init_seed0": int(seeded(True).params["dec0"].shape[-1])},
            "table1": names,
            "release_params_sha256": rel.release["params_sha256"],
        },
        "table1": t1_out,
        "table1_differs_from_f32": {
            "order": [nm for nm in names if t1_out[nm]["order_sha256"] != f32[nm]["order_sha256"]],
            "assignment": [nm for nm in names
                           if t1_out[nm]["assign_sha256"] != f32[nm]["assign_sha256"]]},
        "synthetic": synth_out,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    t0 = time.perf_counter()
    args.out.write_text(json.dumps(build_payload(), indent=1) + "\n")
    print(f"wrote {args.out} in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
