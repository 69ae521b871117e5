#!/usr/bin/env python
"""Write the training golden file from the JAX package.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_train_golden.py \
        [--out tests/golden/torch_train_steps.json]

The first three REINFORCE steps of respect-v1's training configuration
(``checkpoints/respect-v1/release.json`` "train": hidden 128, batch 64, lr
3e-4, |V| 5-50, label method dp, mask_infeasible) under the reference
(``repro``), on the CPU: ``RLTrainer(system=PipelineSystem(4), hidden=128,
lr=3e-4, seed=0, stage_counts=(2, 3, 4, 6, 8))`` on the first three packs
of ``DagSampler(seed=0, n=(5, 50)).packed_stream(64, 4)`` (one pack a size
bucket of the first draw), each trained at the packs' stage count,
``train_step(pack, key, n_stages=4)`` (the trainer's default count is the
first of ``stage_counts``, 2), step ``i`` keyed ``fold_in(PRNGKey(1), i)``.

For each step the file holds:

* the pack's shape, and sha256 digests of its n_valid and exact labels;
* digests of the sampled pass's orders (-1 past ``n_valid``) and stage
  assignments and of the greedy baseline pass's, computed with the
  reference's ``_policy_rewards`` on the parameters before the step, and of
  each pass's per-graph float32 rewards (raw bytes: they are exact);
* the step's metrics (``reward_sample``, ``reward_baseline``,
  ``advantage``, ``entropy``, ``loss``, ``grad_norm``, ``n_graphs``);
* after the step: each parameter leaf's L2 norm and 16 fixed entries
  (leaf and flat index drawn once from ``default_rng(0)``).

``tests/test_torch_train.py`` (on the CPU) and ``chip_smoke.py`` (on the
card) hold the port to it.  Takes about 20 s on a CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "tests" / "golden" / "torch_train_steps.json"
CONFIG = dict(seed=0, key_seed=1, hidden=128, lr=3e-4, batch=64, n=[5, 50], n_stages=4,
              stage_counts=[2, 3, 4, 6, 8], max_deg=6, steps=3, entries=16)


def int_digest(a) -> str:
    import numpy as np
    return hashlib.sha256(np.asarray(a, dtype=np.int64).tobytes()).hexdigest()


def f32_digest(a) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(a, dtype="<f4").tobytes()).hexdigest()


def pass_record(prefix: str, rewards, orders, assigns, n_valid) -> dict:
    import numpy as np
    orders, n_valid = np.asarray(orders), np.asarray(n_valid)
    valid = np.arange(orders.shape[1])[None, :] < n_valid[:, None]
    return {f"{prefix}_order_sha256": int_digest(np.where(valid, orders, -1)),
            f"{prefix}_assign_sha256": int_digest(assigns),
            f"{prefix}_rewards_sha256": f32_digest(rewards)}


def entry_positions(shapes: dict, count: int, seed: int = 0) -> list[tuple[str, int]]:
    """``count`` (leaf, flat index) pairs: a leaf uniformly by sorted name,
    then an index uniformly inside it."""
    import numpy as np
    rng = np.random.default_rng(seed)
    names = sorted(shapes)
    out = []
    for _ in range(count):
        name = names[int(rng.integers(len(names)))]
        out.append((name, int(rng.integers(int(np.prod(shapes[name]))))))
    return out


def build_payload() -> dict:
    import jax
    import numpy as np
    from repro.core import DagSampler, PipelineSystem
    from repro.core.rl import RLTrainer, _policy_rewards

    c = CONFIG
    system = PipelineSystem(c["n_stages"])
    trainer = RLTrainer(system=system, hidden=c["hidden"], lr=c["lr"], seed=c["seed"],
                        stage_counts=tuple(c["stage_counts"]))
    stream = DagSampler(seed=c["seed"], n=tuple(c["n"])).packed_stream(
        c["batch"], c["n_stages"], system=system)
    root = jax.random.PRNGKey(c["key_seed"])
    flat = lambda params: {"/".join(p.key for p in path): np.asarray(leaf)
                           for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    positions = entry_positions({k: v.shape for k, v in flat(trainer.params).items()},
                                c["entries"])
    steps = []
    for i in range(c["steps"]):
        batch = next(stream)
        key = jax.random.fold_in(root, i)
        keys = jax.random.split(key, batch.batch)
        rec = {"bucket_n": batch.bucket_n, "batch": batch.batch,
               "n_valid_sha256": int_digest(batch.n_valid),
               "label_assign_sha256": int_digest(batch.label_assign)}
        for prefix, params, sample in (("sample", trainer.params, True),
                                       ("baseline", trainer.baseline_params, False)):
            r, _, _, orders, assigns = _policy_rewards(params, batch, keys, c["n_stages"],
                                                       system, True, sample)
            rec.update(pass_record(prefix, r, orders, assigns, batch.n_valid))
        rec["metrics"] = trainer.train_step(batch, key, n_stages=c["n_stages"])
        after = flat(trainer.params)
        rec["leaf_norms"] = {k: float(np.linalg.norm(v.astype(np.float64)))
                             for k, v in sorted(after.items())}
        rec["entries"] = [{"leaf": k, "index": j, "value": float(after[k].reshape(-1)[j])}
                          for k, j in positions]
        steps.append(rec)
    return {"meta": {"generator": "scripts/make_train_golden.py (the JAX package, on the CPU)",
                     "config": c,
                     "feed": "DagSampler(seed, n).packed_stream(batch, n_stages), first "
                             "`steps` packs; step i keyed fold_in(PRNGKey(key_seed), i)"},
            "steps": steps}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    args.out.write_text(json.dumps(build_payload(), indent=1) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
