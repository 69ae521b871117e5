"""Shared by ``tests/test_torch_whisper.py``, ``tests/test_torch_xlstm.py`` and
``tests/test_torch_zoo_archs.py``:
one smoke model of the JAX package and its port with the same weights (the
reference's own ``init_params`` carried across by ``params_from_numpy``),
driven through prefill and greedy decode side by side."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.models.lm import params_from_numpy
from repro_torch.models.model import build_model


def pair(arch: str, dtype: str = "float32", **kw):
    """(jax model, jax params, port model, port params); the reference runs
    its Pallas kernels in interpret mode."""
    jcfg = jax_get_smoke_config(arch).scaled(dtype=dtype, **kw)
    cfg = get_smoke_config(arch).scaled(dtype=dtype, **kw)
    jm = jax_build_model(jcfg, remat=False, attn_impl="interpret", ssd_impl="interpret")
    jparams = jm.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jm, jparams, build_model(cfg, device="cpu"), params


def batch(cfg, b: int, s: int, seed: int = 0) -> dict:
    """Prompt tokens (and, for whisper, frame embeddings) as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        out["audio_embed"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return out


def drive(jm, jparams, model, params, inputs: dict, steps: int):
    """Prefill (max_len S + steps) and ``steps`` greedy decode steps in both
    packages, each fed the reference's tokens; S counts the VLM's
    ``patches`` before the prompt, so decode starts at kv_len = S.  Returns
    ([(port logits, reference logits)] for the prefill and each step, port
    cache, reference cache)."""
    s = inputs["tokens"].shape[1] + (inputs["patches"].shape[1] if "patches" in inputs else 0)
    dt = getattr(jnp, model.cfg.dtype)
    jin = {k: jnp.asarray(v, dt if v.dtype == np.float32 else None) for k, v in inputs.items()}
    tin = {k: torch.from_numpy(v) if v.dtype != np.float32 else
           torch.from_numpy(v).to(getattr(torch, model.cfg.dtype)) for k, v in inputs.items()}
    jlog, jcache = jax.jit(jm.prefill, static_argnames="max_len")(jparams, jin, max_len=s + steps)
    logits, cache = model.prefill(params, tin, max_len=s + steps)
    out = [(logits, jlog)]
    jdecode = jax.jit(jm.decode_step)
    for t in range(steps):
        jtok = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
        jlog, jcache = jdecode(jparams, jtok, jcache, jnp.int32(s + t))
        logits, cache = model.decode_step(params, torch.from_numpy(np.array(jtok)), cache, s + t)
        out.append((logits, jlog))
    return out, cache, jcache


def f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
