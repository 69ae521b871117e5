#!/usr/bin/env python
"""Write the seeded-schedule golden file from the JAX package.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_seeded_golden.py \
        [--out tests/golden/torch_seeded_schedules.json]

Everything in the file comes from the reference (``repro``), on the CPU:

* ``leaves`` — sha256 of every leaf of ``init_params(PRNGKey(0), ...)`` at
  hidden 256, 128 and 96 (raw little-endian float32 bytes);
* ``seeded`` — order and assignment digests (sha256 of int64 bytes, one a
  graph) of ``RespectScheduler.init(seed=0, hidden=H).schedule_many`` at
  those widths, on the 64 synthetic graphs (uniform system) and on the
  heterogeneous batch (InceptionResNetv2, ResNet50 and the first 16
  synthetic graphs, per-stage rates and link bandwidths);
* ``sample_order`` — order digests of ``ptrnet.sample_order`` with the
  release ``respect-v1``, graph ``i`` keyed ``fold_in(PRNGKey(1), i)``, on
  the 64 synthetic graphs and on the ten Table-I graphs (in the order of
  ``tests/golden/dnn_schedules.json``);
* ``fallback`` — digests of ``from_release().fallback_schedule_many(...,
  fallback_seed=0)`` on the ten Table-I graphs and the 64 synthetic ones.

The port's tests and ``chip_smoke.py`` read the file as data;
``tests/test_torch_serving.py`` re-derives its synthetic part (bucket 32)
from JAX with the functions below, so the file cannot drift from the
reference.  Takes about two minutes on a CPU.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "tests" / "golden" / "torch_seeded_schedules.json"
DNN_GOLDEN = ROOT / "tests" / "golden" / "dnn_schedules.json"
SEED = 0
SAMPLE_SEED = 1
FALLBACK_SEED = 0
HIDDENS = (256, 128, 96)
N_STAGES = 4
MAX_DEG = 6
N_SYNTH = 64
HETERO = dict(n_stages=N_STAGES, compute_rate=(4e12, 2e12, 4e12, 8e12),
              link_bw=(320e6, 160e6, 320e6, 640e6))
HETERO_MODELS = ("InceptionResNetv2", "ResNet50")
N_HETERO_SYNTH = 16


def digest(arr) -> str:
    import numpy as np
    return hashlib.sha256(np.asarray(arr, dtype=np.int64).tobytes()).hexdigest()


def leaf_digest(arr) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(arr, dtype="<f4").tobytes()).hexdigest()


def synthetic():
    import numpy as np
    from repro.core import sample_batch
    return sample_batch(np.random.default_rng(0), N_SYNTH, n=30)


def table1_names() -> list[str]:
    return list(json.loads(DNN_GOLDEN.read_text())["models"])


def table1():
    from repro.core import build_model_graph
    return [build_model_graph(nm) for nm in table1_names()]


def hetero_batch(t1, synth):
    names = table1_names()
    return [t1[names.index(nm)] for nm in HETERO_MODELS] + synth[:N_HETERO_SYNTH]


def leaf_digests(hidden: int) -> dict:
    import jax
    import numpy as np
    from repro.core import embed_dim, ptrnet
    params = ptrnet.init_params(jax.random.PRNGKey(SEED), embed_dim(MAX_DEG), hidden)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(p.key for p in path): leaf_digest(np.asarray(leaf)) for path, leaf in flat}


def schedule_digests(results) -> dict:
    return {"order_sha256": [digest(r["order"]) for r in results],
            "assign_sha256": [digest(r["assignment"]) for r in results]}


def seeded_digests(hidden: int, graphs, system=None) -> dict:
    from repro.core import PipelineSystem, RespectScheduler
    sched = RespectScheduler.init(seed=SEED, hidden=hidden)
    system = system or PipelineSystem(N_STAGES)
    return schedule_digests(sched.schedule_many(graphs, N_STAGES, system, use_cache=False))


def release_params():
    from repro.core import RespectScheduler
    sched = RespectScheduler.from_release()
    if sched.release is None:
        raise SystemExit("checkpoints/respect-v1 did not load")
    return sched


def sample_digests(params, graphs) -> list[str]:
    """Order digest of each graph's sampled decode, unpadded, graph ``i``
    keyed ``fold_in(PRNGKey(SAMPLE_SEED), i)`` (one compile per size)."""
    import jax
    import jax.numpy as jnp
    from repro.core import embed_graph, ptrnet
    run = jax.jit(functools.partial(ptrnet.sample_order, params))
    root = jax.random.PRNGKey(SAMPLE_SEED)
    out = []
    for i, g in enumerate(graphs):
        order, _, _ = run(jnp.asarray(embed_graph(g, MAX_DEG)),
                          jnp.asarray(g.parent_matrix(MAX_DEG)), jax.random.fold_in(root, i))
        out.append(digest(order))
    return out


def build_payload() -> dict:
    from repro.core import PipelineSystem
    synth, t1 = synthetic(), table1()
    names = table1_names()
    hetero = hetero_batch(t1, synth)
    hsys = PipelineSystem(**HETERO)
    release = release_params()
    fb = release.fallback_schedule_many(t1 + synth, N_STAGES, fallback_seed=FALLBACK_SEED)
    sampled_t1 = sample_digests(release.params, t1)
    return {
        "meta": {
            "generator": "scripts/make_seeded_golden.py (the JAX package, on the CPU)",
            "seed": SEED, "sample_seed": SAMPLE_SEED, "fallback_seed": FALLBACK_SEED,
            "n_stages": N_STAGES, "max_deg": MAX_DEG,
            "synthetic": f"sample_batch(default_rng(0), {N_SYNTH}, n=30)",
            "hetero": {"models": list(HETERO_MODELS), "synthetic_prefix": N_HETERO_SYNTH,
                       "system": HETERO},
            "table1": names,
            "release_params_sha256": release.release["params_sha256"],
        },
        "leaves": {str(h): leaf_digests(h) for h in HIDDENS},
        "seeded": {str(h): {"synthetic": seeded_digests(h, synth),
                            "hetero": seeded_digests(h, hetero, hsys)} for h in HIDDENS},
        "sample_order": {"synthetic": sample_digests(release.params, synth),
                         "table1": dict(zip(names, sampled_t1))},
        "fallback": {"table1": {nm: {"order_sha256": digest(r["order"]),
                                     "assign_sha256": digest(r["assignment"])}
                                for nm, r in zip(names, fb[: len(t1)])},
                     "synthetic": schedule_digests(fb[len(t1):])},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    args.out.write_text(json.dumps(build_payload(), indent=1) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
