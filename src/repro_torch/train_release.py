"""Release training: the port's twin of ``scripts/train_release.py``.

Runs the paper's training recipe end to end on the port's
:class:`~repro_torch.core.rl.RLTrainer`: a mixed-size synthetic DAG
curriculum (|V| = ``--n-min`` .. ``--n-max``, small graphs first), rotating
over the eval grid's stage counts (``--stage-counts``, one REINFORCE step
per draw at k = the draw's count, all on one trainer state), exact-DP
labels on the device (:func:`repro_torch.core.rl.pack_graphs`), to a
convergence criterion: training stops when the held-out mean exact-match
across all stage counts reaches ``--target-match``, when it fails to improve
for ``--patience`` consecutive evals, or at ``--max-steps``.

The curriculum is the reference's topology mixture (:data:`FAMILY_MIX`: the
paper's ``sample_dag`` mixture plus the eval grid's chain / layered /
branchy families) and the same stream: draw ``count`` is a pure function of
``(seed, count)`` (:func:`_draw`), and step ``count``'s key is
``prng.fold_in(PRNGKey(seed), count)``, bit for bit ``jax.random``'s.  So
the two scripts feed their trainers the same graphs and keys.

The output is a versioned release (:func:`repro_torch.checkpoint.write_release`):
``<out>/release.json`` pins the config, data seed, curriculum and the sha256
of the parameter bytes; ``<out>/params/`` holds the weights.  Both packages'
``RespectScheduler.from_release(<out>)`` load it.

    python -m repro_torch.train_release --max-steps 6 --out /tmp/rel

Resumable: ``--ckpt-dir`` keeps trainer checkpoints and the draw counter
(``draw_count.json``); kill and re-run with the same flags to continue.
Runs on the card unless ``--device`` names another.  ``--devices > 1`` raises
as :class:`RLTrainer` does (data parallelism is ROADMAP.md queue A item 2.2).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from datetime import datetime, timezone
from pathlib import Path

import numpy as np

from .checkpoint.release import write_release
from .core import prng
from .core.batching import bucket_for
from .core.costmodel import PipelineSystem
from .core.embedding import embed_dim
from .core.ptrnet import param_tree
from .core.rl import RLTrainer, pack_graphs
from .core.sampler import sample_dag
from .device import resolve_device
from .eval.scenarios import SYNTH_FAMILIES, synthetic_dag

__all__ = ["FAMILY_MIX", "main"]

# curriculum topology mixture: the paper sampler + the eval families
FAMILY_MIX = ("paper",) + SYNTH_FAMILIES


def _mixed_graphs(rng: np.random.Generator, batch: int, n_spec: tuple[int, int]) -> list:
    """``batch`` graphs, each drawing its own family and size."""
    graphs = []
    for _ in range(batch):
        fam = FAMILY_MIX[int(rng.integers(len(FAMILY_MIX)))]
        n = int(rng.integers(n_spec[0], n_spec[1] + 1))
        if fam == "paper":
            graphs.append(sample_dag(rng, n=n, deg=int(rng.choice((2, 3, 4, 5, 6)))))
        else:
            graphs.append(synthetic_dag(fam, rng, n))
    return graphs


def _git_sha() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                              cwd=Path(__file__).resolve().parent, check=True).stdout.strip()
    except Exception:
        return "unknown"


def _draw(seed: int, count: int, batch: int, n_lo: int, n_hi: int, ramp_batches: int):
    """One deterministic curriculum draw: (seed, count) -> graphs.

    The size range ramps from [n_lo, n_lo + ..] to the full [n_lo, n_hi]
    over the first ``ramp_batches`` draws (small graphs first), and every
    draw is a pure function of (seed, count), so a resumed run continues the
    identical stream.
    """
    n_spec = (n_lo, n_hi)
    if count < ramp_batches:
        frac = (count + 1) / ramp_batches
        n_spec = (n_lo, n_lo + max(1, int((n_hi - n_lo) * frac)))
    rng = np.random.default_rng((seed, count))
    return _mixed_graphs(rng, batch, n_spec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.train_release")
    ap.add_argument("--out", default="checkpoints/respect-v1")
    ap.add_argument("--version", default="respect-v1")
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-min", type=int, default=5)
    ap.add_argument("--n-max", type=int, default=50)
    ap.add_argument("--stage-counts", default="2,3,4,6,8",
                    help="comma list; one draw per k, round-robin")
    ap.add_argument("--ramp-batches", type=int, default=64,
                    help="curriculum: draws to widen |V| range over")
    ap.add_argument("--max-steps", type=int, default=4000)
    ap.add_argument("--eval-every", type=int, default=50,
                    help="evals are counted in draws")
    ap.add_argument("--target-match", type=float, default=0.98,
                    help="stop when held-out mean exact-match across all stage counts "
                         "reaches this")
    ap.add_argument("--patience", type=int, default=10,
                    help="stop after this many evals without improvement")
    ap.add_argument("--entropy-coef", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label-cache", default="artifacts/label_cache")
    ap.add_argument("--ckpt-dir", default="artifacts/release_train_ckpt")
    ap.add_argument("--save-every", type=int, default=200)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    stage_counts = tuple(int(s) for s in args.stage_counts.split(","))
    device = resolve_device(args.device)

    base = PipelineSystem(n_stages=stage_counts[0])
    trainer = RLTrainer(system=base, hidden=args.hidden, lr=args.lr, seed=args.seed,
                        n_devices=args.devices, entropy_coef=args.entropy_coef,
                        stage_counts=stage_counts, device=device)
    bucket_n = bucket_for(args.n_max)

    def pack(graphs, k):
        return pack_graphs(graphs, k, base.with_stages(k), cache_dir=args.label_cache,
                           bucket_n=bucket_n, device=device)

    # held-out eval sets: one per stage count, disjoint seed stream, same
    # topology mixture as the curriculum
    eval_batches = {}
    for k in stage_counts:
        rng = np.random.default_rng((args.seed + 10 ** 6, k))
        eval_batches[k] = pack(_mixed_graphs(rng, 128, (args.n_min, args.n_max)), k)

    def held_out() -> tuple[float, float]:
        rs, ms = [], []
        for k in stage_counts:
            ev = trainer.evaluate(eval_batches[k], n_stages=k)
            rs.append(ev["reward_greedy"])
            ms.append(ev["exact_match"])
        return float(np.mean(rs)), float(np.mean(ms))

    # resume
    ckpt_dir = Path(args.ckpt_dir)
    count_path = ckpt_dir / "draw_count.json"
    count = 0
    resumed = trainer.restore(args.ckpt_dir)
    if resumed is not None and count_path.exists():
        count = int(json.loads(count_path.read_text())["count"])
        print(f"[resume] trainer step {resumed}, draw count {count}")

    def save(blocking=True):
        trainer.save(args.ckpt_dir, blocking=blocking)
        count_path.write_text(json.dumps({"count": count}))

    key = prng.PRNGKey(args.seed)
    r0, m0 = held_out()
    print(f"[init] mean greedy reward {r0:.4f} exact-match {m0:.3f} over k={stage_counts}")

    best_match, bad_evals, t0 = m0, 0, time.time()
    converged = None
    history = []
    while trainer.step_count < args.max_steps:
        k = stage_counts[count % len(stage_counts)]
        graphs = _draw(args.seed, count, args.batch, args.n_min, args.n_max,
                       args.ramp_batches)
        count += 1
        batch = pack(graphs, k)
        metrics = trainer.train_step(batch, prng.fold_in(key, count), n_stages=k)
        if count % 10 == 0:
            print(f"[step {trainer.step_count} draw {count} k={k}] "
                  f"reward={metrics['reward_sample']:.4f} "
                  f"baseline={metrics['reward_baseline']:.4f} "
                  f"({(time.time() - t0) / count:.2f}s/draw)", flush=True)
        if count % args.eval_every == 0:
            r, m = held_out()
            trainer.consider_baseline(r)
            history.append({"step": trainer.step_count, "draws": count, "reward": r,
                            "exact_match": m})
            improved = m > best_match + 1e-4
            bad_evals = 0 if improved else bad_evals + 1
            best_match = max(best_match, m)
            print(f"[eval step {trainer.step_count}] reward={r:.4f} exact-match={m:.3f} "
                  f"best={best_match:.3f} stale={bad_evals}/{args.patience}", flush=True)
            if m >= args.target_match:
                converged = f"target exact-match {args.target_match} reached"
                break
            if bad_evals >= args.patience:
                converged = f"no improvement for {args.patience} evals"
                break
        if count % args.save_every == 0:
            save(blocking=False)
    save()
    if converged is None:
        converged = f"max steps {args.max_steps} reached"

    r_final, m_final = held_out()
    print(f"[done] {converged}; mean greedy reward {r_final:.4f} exact-match {m_final:.3f} "
          f"(init {r0:.4f}/{m0:.3f})")

    manifest = write_release(param_tree(trainer.params), args.out, {
        "version": args.version,
        "created": datetime.now(timezone.utc).isoformat(timespec="seconds"),
        "git_sha": _git_sha(),
        "config": {"hidden": args.hidden, "feat_dim": embed_dim(), "mask_infeasible": True,
                   "max_deg": 6},
        "train": {
            "data_seed": args.seed, "n_range": [args.n_min, args.n_max],
            "family_mix": list(FAMILY_MIX),
            "stage_counts": list(stage_counts), "batch": args.batch,
            "lr": args.lr, "label_method": "dp",
            "ramp_batches": args.ramp_batches,
            "steps": trainer.step_count, "draws": count,
            "stopped": converged,
            "command": "python -m repro_torch.train_release " + " ".join(
                sys.argv[1:] if argv is None else argv),
        },
        "eval": {"reward_greedy_mean": r_final, "exact_match_mean": m_final,
                 "stage_counts": list(stage_counts), "history": history[-20:]},
        "system": dataclasses.asdict(base),
    })
    print(f"[release] wrote {args.out} (params sha256 {manifest['params_sha256'][:16]}...)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
