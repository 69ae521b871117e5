"""Train an LM of the zoo with the port's training stack (the twin of the
reference's ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.train_lm --arch whisper-tiny --steps 50
    PYTHONPATH=src python -m repro_torch.train_lm --arch xlstm-350m --device cpu --steps 4

The smoke config of a ported architecture (``--layers`` rescales one without
a block pattern), the reference's ``TrainConfig(microbatches=2, lr=1e-3,
warmup_steps=10, weight_decay=0.01)``, AdamW with warmup-cosine, the
deterministic token stream (whisper also gets zero frame embeddings), and
the fault-tolerant :class:`~repro_torch.runtime.TrainLoop`: metrics JSONL,
checkpoints under ``--ckpt-dir/<arch>`` every ``--save-every`` steps, and a
resume from the newest one when the command is run again.  Runs on the card
unless ``--device cpu`` is given; without CUDA it raises.  An architecture
the port does not build raises the registry's ``KeyError``, which names the
ported ones.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from .configs import TrainConfig, get_smoke_config
from .data import TokenStream
from .launch import make_optimizer, make_train_fn
from .models.model import build_model, count_params
from .runtime import TrainLoop, TrainLoopConfig

__all__ = ["train_config", "batch_fn_for", "make_loop", "main"]


def train_config(total_steps: int) -> TrainConfig:
    """The example's trainer knobs."""
    return TrainConfig(microbatches=2, lr=1e-3, warmup_steps=10, total_steps=total_steps,
                       weight_decay=0.01)


def batch_fn_for(cfg, stream: TokenStream, device: torch.device):
    """``step -> batch`` on ``device``: the stream's tokens, and for the
    audio family zero frame embeddings (B, encoder_seq, d) in bfloat16."""
    def batch_fn(step: int) -> dict:
        out = {k: torch.from_numpy(v).to(device) for k, v in stream.batch_at(step).items()}
        if cfg.family == "audio":
            out["audio_embed"] = torch.zeros((stream.local_batch, cfg.encoder_seq, cfg.d_model),
                                             dtype=torch.bfloat16, device=device)
        return out
    return batch_fn


def make_loop(cfg, *, steps: int, batch: int, seq: int, ckpt_dir, save_every: int = 10,
              metrics_path=None, device=None, params=None, log_every: int = 5) -> TrainLoop:
    """The training loop of ``cfg`` on ``device`` (the card unless named):
    parameters ``params`` (default: ``init_params(seed=0)`` on the device),
    a fresh AdamW state, and the token stream of seed 0."""
    model = build_model(cfg, device=device, remat=False)   # as the reference's example
    tcfg = train_config(steps)
    optimizer = make_optimizer(tcfg)
    if params is None:
        params = model.init_params(seed=0)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0)
    return TrainLoop(step_fn=make_train_fn(model, tcfg, optimizer),
                     batch_fn=batch_fn_for(cfg, stream, model.device), params=params,
                     opt_state=optimizer.init(params),
                     config=TrainLoopConfig(total_steps=steps, save_every=save_every,
                                            log_every=log_every),
                     ckpt_dir=ckpt_dir, metrics_path=metrics_path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="whisper-tiny")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="artifacts/lm_ckpt")
    ap.add_argument("--metrics", default=None,
                    help="metrics JSONL (default artifacts/lm_train_<arch>.jsonl)")
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if cfg.block_pattern is None:
        cfg = cfg.scaled(n_layers=args.layers)
    model = build_model(cfg, device=args.device, remat=False)
    print(f"[model] {args.arch} (reduced): {count_params(model) / 1e6:.2f}M params on "
          f"{model.device}")
    loop = make_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                     ckpt_dir=Path(args.ckpt_dir) / args.arch, save_every=args.save_every,
                     metrics_path=args.metrics or f"artifacts/lm_train_{args.arch}.jsonl",
                     device=model.device)
    out = loop.run()
    print(f"[done] {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
