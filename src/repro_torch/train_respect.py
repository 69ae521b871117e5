"""Train the RESPECT agent with REINFORCE: the port's twin of
``examples/train_respect.py`` (paper §III-B), with its flags and defaults.

Synthetic DAG sampler (fixed |V| = ``--n-min`` = ``--n-max``, or a mixed-size
range with a small-first curriculum) -> exact labels (the DP on the device,
an on-disk cache) -> the pointer network and the rollout-baseline REINFORCE
of :class:`~repro_torch.core.rl.RLTrainer` -> a scheduler checkpoint at
``--out`` (the checkpoint format ``RespectScheduler.load`` reads).  Step
``s``'s key is ``fold_in(PRNGKey(seed), s)``, bit for bit ``jax.random``'s.

Defaults are the reference's (hidden 128, batch 64, lr 3e-4, 300 steps);
``--paper-scale`` selects the paper's setup (hidden 256, batch 128, lr
1e-4).

    python -m repro_torch.train_respect --steps 300
    python -m repro_torch.train_respect --n-min 10 --n-max 50     # curriculum
    python -m repro_torch.train_respect --devices 2 --backend gloo --share-device

Resumable: ``--ckpt-dir`` keeps trainer checkpoints and, beside them,
``sampler_state.json``: the sampler's (seed, counter) before the draw of the
last pack trained on and how many of that draw's packs were consumed.  A
resumed run therefore trains on exactly the packs, with exactly the keys, the
uninterrupted run would have (the reference saves the counter of its
prefetching sampler, which may skip a few draws).

``--devices n > 1`` trains data-parallel on ``n`` ranks
(:func:`repro_torch.parallel.data.run_ranks`): every rank draws the same
packs from the same seed (``packed_stream(..., batch_divisor=n)``) and steps
its slice; metrics, prints, checkpoints and the output come from rank 0.
``--backend`` is ``nccl`` (one card a rank) unless named; ranks that share
one card (``--share-device``) need ``--backend gloo``.  Runs on the card
unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

from .checkpoint import save_pytree
from .core import prng
from .core.costmodel import PipelineSystem
from .core.ptrnet import params_to_numpy
from .core.rl import RLTrainer
from .core.sampler import DagSampler, prefetch
from .device import resolve_device
from .runtime.metrics import MetricsLogger

__all__ = ["main", "parse_args", "train"]

#: how long the ranks of a data-parallel run may take in all
RANK_TIMEOUT_S = 7 * 24 * 3600.0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.train_respect")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--n-min", type=int, default=30, help="smallest sampled graph size")
    ap.add_argument("--n-max", type=int, default=30,
                    help="largest sampled graph size (n-min < n-max turns on the mixed-size "
                         "curriculum stream)")
    ap.add_argument("--no-curriculum", action="store_true",
                    help="mixed sizes without the small-first ramp")
    ap.add_argument("--devices", type=int, default=None,
                    help="data-parallel rank count (the global batch must divide it)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="process-group backend of --devices > 1 (default: nccl)")
    ap.add_argument("--share-device", action="store_true",
                    help="every rank on the one card (gloo only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain path)")
    ap.add_argument("--label-method", choices=("dp", "bb"), default="dp")
    ap.add_argument("--label-cache", default="artifacts/label_cache")
    ap.add_argument("--ckpt-dir", default="artifacts/respect_ckpt")
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--paper-scale", action="store_true",
                    help="hidden 256, batch 128, lr 1e-4 (paper setup)")
    ap.add_argument("--out", default="artifacts/respect_agent")
    ap.add_argument("--metrics", default="artifacts/respect_train_metrics.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.paper_scale:
        args.hidden, args.batch, args.lr = 256, 128, 1e-4
    return args


def _tagged(sampler: DagSampler, packs):
    """Each pack with the sampler state that resumes the stream after it:
    the counter before the pack's draw and how many of that draw's packs
    have been yielded (read as the pack is yielded, before any prefetch)."""
    last, idx = None, 0
    for pack in packs:
        count = sampler.state()["count"]
        idx = idx + 1 if count == last else 0
        last = count
        yield pack, {"seed": sampler.seed, "count": count - 1, "skip": idx + 1}


def _write_json(path: Path, obj) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(obj))
    os.replace(tmp, path)


def train(world, device, args: argparse.Namespace) -> dict:
    """The training loop of one process (``world`` None) or of one rank of
    a data-parallel run.  Returns the final step, the last metrics and the
    final eval."""
    main = world is None or world.is_main
    say = print if main else (lambda *a, **k: None)
    system = PipelineSystem(n_stages=args.stages)
    n_spec = (args.n_min, args.n_max) if args.n_min < args.n_max else args.n_min
    sampler = DagSampler(seed=args.seed, n=n_spec, label_cache_dir=args.label_cache)
    eval_sampler = DagSampler(seed=args.seed + 10**6, n=n_spec, label_cache_dir=args.label_cache)
    eval_batch = eval_sampler.next_packed_batch(128, args.stages, system,
                                                label_method=args.label_method, device=device)
    trainer = RLTrainer(n_stages=args.stages, system=system, hidden=args.hidden, lr=args.lr,
                        seed=args.seed, n_devices=args.devices, device=device)
    ckpt = Path(args.ckpt_dir)
    state_path = ckpt / "sampler_state.json"
    consumed = {"seed": args.seed, "count": 0, "skip": 0}

    def save_all(blocking: bool = True) -> None:
        trainer.save(ckpt, blocking=blocking)
        if main:
            _write_json(state_path, consumed)

    skip = 0
    resumed = trainer.restore(ckpt)
    if resumed is not None:
        if state_path.exists():
            consumed = json.loads(state_path.read_text())
            sampler.restore(consumed)
            skip = int(consumed.get("skip", 0))
        say(f"[resume] restored trainer checkpoint at step {resumed} (sampler counter "
            f"{sampler.state()['count']}, {skip} packs of that draw consumed)", flush=True)
    logger = MetricsLogger(args.metrics if main else None, print_every=10 if main else 1 << 62)
    key = prng.PRNGKey(args.seed)

    r0 = trainer.evaluate(eval_batch)
    say(f"[init] greedy reward {r0['reward_greedy']:.4f} exact-match {r0['exact_match']:.3f}",
        flush=True)
    if world is not None:
        say(f"[data parallel] {world.size} ranks, backend {world.backend}, device {device}",
            flush=True)

    stream = prefetch(_tagged(sampler, sampler.packed_stream(
        args.batch, args.stages, system, label_method=args.label_method,
        curriculum=not args.no_curriculum, batch_divisor=args.devices or 1, device=device)),
        depth=2)
    for _ in range(skip):
        next(stream)

    t0 = time.time()
    step = trainer.step_count
    metrics: dict = {}
    while step < args.steps:
        batch, consumed = next(stream)
        metrics = trainer.train_step(batch, prng.fold_in(key, step))
        step = trainer.step_count
        logger.log(step, metrics)
        if step % args.eval_every == 0:
            updated = trainer.maybe_update_baseline(eval_batch)
            ev = trainer.evaluate(eval_batch)
            say(f"[eval step {step}] greedy={ev['reward_greedy']:.4f} "
                f"exact-match={ev['exact_match']:.3f} baseline-updated={updated} "
                f"({(time.time() - t0) / max(step, 1):.2f}s/step)", flush=True)
        if step % args.save_every == 0:
            save_all(blocking=False)

    save_all()
    ev = trainer.evaluate(eval_batch)
    say(f"[final] greedy reward {ev['reward_greedy']:.4f} (start {r0['reward_greedy']:.4f}) "
        f"exact-match {ev['exact_match']:.3f}", flush=True)
    if main:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        save_pytree(params_to_numpy(trainer.params), out)
        say(f"[saved] {out}", flush=True)
    return {"step": step, "metrics": metrics, "eval": ev}


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.devices is not None and args.devices > 1:
        from .parallel.data import run_ranks
        backend = args.backend or "nccl"
        print(f"[data parallel] starting {args.devices} ranks, backend {backend}"
              + (", sharing one card" if args.share_device else ""), flush=True)
        run_ranks(train, args.devices, backend=backend, device=args.device,
                  share_device=args.share_device, timeout_s=RANK_TIMEOUT_S, args=(args,))
        return 0
    train(None, resolve_device(args.device), args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
