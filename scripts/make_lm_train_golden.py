#!/usr/bin/env python
"""Write the LM training golden file from the JAX package.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_lm_train_golden.py \
        [--out tests/golden/torch_lm_train_steps.json]

For each ported SMOKE architecture (zamba2-7b, whisper-tiny, xlstm-350m), in
float32, the reference (``repro``) trains three steps of
``examples/train_lm.py``'s configuration on the CPU:
``build_model(cfg, remat=False, attn_impl="chunked", ssd_impl="chunked")``,
``TrainConfig(microbatches=2, lr=1e-3, warmup_steps=10, total_steps=50,
weight_decay=0.01)``, ``make_optimizer`` and ``make_train_fn`` under
``jax.jit``, on ``TokenStream(vocab_size, seq_len=16, global_batch=4,
seed=0)`` (and, for whisper, zero bfloat16 frame embeddings).

The weights are the port's host-drawn ones,
``repro_torch`` ``Model.init_params(seed=0, host=True)``: threefry draws,
the same bits on every machine, carried into the reference's parameter tree
(its structure, shapes and dtypes).  So the port, on the CPU
(``tests/test_torch_lm_train.py``) and on the card (``chip_smoke.py``),
starts from the weights the file was made with, without JAX.

For each step the file holds the batch's tokens (so a machine whose numpy
draws another Zipf stream still trains on these), the metrics ``loss`` and
``grad_norm``; after the third step every parameter leaf's L2 norm
(float64 over the float32 values); and the sha256 of the initial weights'
float32 bytes (leaves in sorted name order).  Takes about 30 s on a CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "tests" / "golden" / "torch_lm_train_steps.json"
ARCHS = ("zamba2-7b", "whisper-tiny", "xlstm-350m")
CONFIG = dict(dtype="float32", seed=0, stream_seed=0, batch=4, seq=16, steps=3, microbatches=2,
              lr=1e-3, warmup_steps=10, total_steps=50, weight_decay=0.01)


def named_leaves(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += named_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]
    return out


def params_sha256(named) -> str:
    import hashlib

    import numpy as np
    h = hashlib.sha256()
    for _, leaf in named:
        h.update(np.ascontiguousarray(leaf, dtype="<f4").tobytes())
    return h.hexdigest()


def run_arch(arch: str) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import TrainConfig, get_smoke_config
    from repro.data import TokenStream
    from repro.launch import steps as steps_mod
    from repro.models.model import build_model
    from repro_torch.configs import get_smoke_config as port_smoke_config
    from repro_torch.models.model import build_model as port_build_model

    cfg = get_smoke_config(arch).scaled(dtype=CONFIG["dtype"])
    port = port_build_model(port_smoke_config(arch).scaled(dtype=CONFIG["dtype"]), device="cpu")
    host = port.init_params(seed=CONFIG["seed"], host=True)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), host)
    init_sha = params_sha256(named_leaves(jax.tree.map(np.asarray, params)))
    model = build_model(cfg, remat=False, attn_impl="chunked", ssd_impl="chunked")
    want = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    assert jax.tree.structure(want) == jax.tree.structure(params)
    for w, p in zip(jax.tree.leaves(want), jax.tree.leaves(params)):
        assert w.shape == p.shape and w.dtype == p.dtype, (w, p.shape, p.dtype)

    tcfg = TrainConfig(microbatches=CONFIG["microbatches"], lr=CONFIG["lr"],
                       warmup_steps=CONFIG["warmup_steps"], total_steps=CONFIG["total_steps"],
                       weight_decay=CONFIG["weight_decay"])
    optimizer = steps_mod.make_optimizer(tcfg)
    train_fn = jax.jit(steps_mod.make_train_fn(model, tcfg, optimizer))
    opt_state = optimizer.init(params)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=CONFIG["seq"],
                         global_batch=CONFIG["batch"], seed=CONFIG["stream_seed"])
    steps = []
    for step in range(CONFIG["steps"]):
        tokens = stream.batch_at(step)["tokens"]
        batch = {"tokens": jnp.asarray(tokens)}
        if cfg.family == "audio":
            batch["audio_embed"] = jnp.zeros((CONFIG["batch"], cfg.encoder_seq, cfg.d_model),
                                             jnp.bfloat16)
        params, opt_state, metrics = train_fn(params, opt_state, batch)
        steps.append({"tokens": tokens.tolist(), "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"]), "step": int(metrics["step"])})
    norms = {name: float(np.linalg.norm(np.asarray(leaf, np.float64).ravel()))
             for name, leaf in named_leaves(jax.tree.map(np.asarray, params))}
    return {"init_sha256": init_sha, "steps": steps, "leaf_norms": norms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    out = {"config": CONFIG, "archs": {arch: run_arch(arch) for arch in ARCHS}}
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    for arch, rec in out["archs"].items():
        print(arch, [round(s["loss"], 6) for s in rec["steps"]])
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
