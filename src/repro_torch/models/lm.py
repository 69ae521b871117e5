"""Decoder-only LM assembly for hybrid patterns (``repro.models.lm``).

The layer pattern is decomposed as ``unit * n_full + tail``.  Parameters
keep the reference's pytree as nested dicts: the ``n_full`` unit repetitions
are stacked leaves with a leading ``n_full`` axis under ``blocks/u{i}``; a
shared-weight block (token ``A``, zamba2) has one parameter set,
``shared_attn``, used at every call site, while its per-site caches stack
like the others; the tail blocks sit under ``tail/t{i}``.  The reference's
layer scan becomes a Python loop over per-layer slices (views) of the
stacks.

Caches are filled in place: prefill writes each layer's cache into a cache
of ``max_len`` (default S) and decode writes its new entries into the cache
it is given, which it returns.  Training (``lm_loss``) runs the blocks in
``mode="train"`` with no cache.

VLM (llava-next): ``batch["patches"]`` (B, n_patches, d), the stub front
end's precomputed patch embeddings, are prefixed to the embedded text
tokens; the loss scores the text region only, and decode positions continue
from ``kv_len``, which counts the prefix.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import trace_hooks
from . import blocks, flags
from .common import (Init, constrain, distribute_tree, dtype_of, embed_lookup, lift_layers,
                     rms_norm, softmax_cross_entropy, write_seq)

__all__ = [
    "decompose_pattern", "rematerialized", "init_lm", "lm_axes", "init_lm_cache", "lm_cache_axes", "lm_forward",
    "lm_loss", "lm_prefill", "pad_cache_to", "lm_decode_step", "params_from_numpy",
    "tree_from_numpy",
]

# cache leaves with a sequence axis (padded by pad_cache_to): GQA K/V and the
# MLA latents
_SEQ_CACHE_KEYS = {"k", "v", "ckv", "krope"}


def decompose_pattern(cfg):
    unit = cfg.block_pattern or "a"
    pattern = cfg.pattern()
    n_full = len(pattern) // len(unit)
    return unit, n_full, pattern[n_full * len(unit):]


def init_lm(init: Init, cfg):
    unit, n_full, tail = decompose_pattern(cfg)
    dt = dtype_of(cfg)
    params = {
        "embed": init.normal((cfg.vocab_size, cfg.d_model), 0.02, dt),
        "final_norm": init.full((cfg.d_model,), 1.0, torch.float32),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init.normal((cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5, dt)
    if "A" in unit:
        params["shared_attn"] = blocks.init_block(init, cfg, "A")
    params["blocks"] = {f"u{i}": blocks.init_block(init.stacked(n_full), cfg, tok)
                        for i, tok in enumerate(unit) if tok != "A" and n_full > 0}
    params["tail"] = {f"t{i}": blocks.init_block(init, cfg, tok) for i, tok in enumerate(tail)}
    return params


def lm_axes(cfg):
    """The logical-sharding tree of :func:`init_lm`'s parameters."""
    unit, n_full, tail = decompose_pattern(cfg)
    ax = {"embed": ("vocab", "embed_nofsdp"), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        ax["lm_head"] = ("embed_nofsdp", "vocab")
    if "A" in unit:
        ax["shared_attn"] = blocks.block_axes(cfg, "A")
    ax["blocks"] = {f"u{i}": lift_layers(blocks.block_axes(cfg, tok))
                    for i, tok in enumerate(unit) if tok != "A" and n_full > 0}
    ax["tail"] = {f"t{i}": blocks.block_axes(cfg, tok) for i, tok in enumerate(tail)}
    return ax


def init_lm_cache(init: Init, cfg, batch: int, max_len: int):
    unit, n_full, tail = decompose_pattern(cfg)
    return {"blocks": {f"u{i}": blocks.init_block_cache(init.stacked(n_full), cfg, tok,
                                                        batch, max_len)
                       for i, tok in enumerate(unit) if n_full > 0},
            "tail": {f"t{i}": blocks.init_block_cache(init, cfg, tok, batch, max_len)
                     for i, tok in enumerate(tail)}}


def lm_cache_axes(cfg):
    """The logical-sharding tree of :func:`init_lm_cache`'s cache."""
    unit, n_full, tail = decompose_pattern(cfg)
    return {"blocks": {f"u{i}": lift_layers(blocks.block_cache_axes(cfg, tok))
                       for i, tok in enumerate(unit) if n_full > 0},
            "tail": {f"t{i}": blocks.block_cache_axes(cfg, tok) for i, tok in enumerate(tail)}}


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _store(slot, new) -> None:
    """Write one layer's new cache into its slot of the full cache (none in
    training)."""
    if slot is None:
        return
    for key, val in new.items():
        if isinstance(val, dict):
            _store(slot[key], val)
            continue
        if val is slot[key]:
            continue
        if key in _SEQ_CACHE_KEYS:
            write_seq(slot[key], 0, val)
        else:
            slot[key].copy_(val)


def rematerialized(body, remat: bool):
    """``body`` (activations -> activations), run under
    ``torch.utils.checkpoint`` (non-reentrant) where ``remat`` is on and
    gradients are enabled: the reference's ``jax.checkpoint`` of a unit
    body.  Its activations are not saved; the backward recomputes them."""
    if not (remat and torch.is_grad_enabled()):
        return body
    from torch.utils.checkpoint import checkpoint
    return lambda x: checkpoint(body, x, use_reentrant=False)


def _backbone(params, cfg, x, positions, *, mode, cache, kv_len, remat=False):
    unit, n_full, tail = decompose_pattern(cfg)
    shared = params.get("shared_attn")

    def unit_body(layer):
        def run(x):
            for i, tok in enumerate(unit):
                p = shared if tok == "A" else _layer(params["blocks"][f"u{i}"], layer)
                slot = None if cache is None else _layer(cache["blocks"][f"u{i}"], layer)
                x, nc = blocks.block_forward(p, cfg, tok, x, positions, mode=mode,
                                             cache=slot if mode == "decode" else None,
                                             kv_len=kv_len)
                _store(slot, nc)
            return x
        return run

    for layer in trace_hooks.loop("layers", n_full):
        x = rematerialized(unit_body(layer), remat and mode == "train")(x)
    for i, tok in enumerate(tail):
        slot = None if cache is None else cache["tail"][f"t{i}"]
        x, nc = blocks.block_forward(params["tail"][f"t{i}"], cfg, tok, x, positions, mode=mode,
                                     cache=slot if mode == "decode" else None, kv_len=kv_len)
        _store(slot, nc)
    return x


def _logits(params, cfg, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return constrain(x @ head, ("batch", "act_seq", "vocab"))


def _n_prefix(cfg, batch) -> int:
    """Positions before the text: the vision stub's patches, if given."""
    return batch["patches"].shape[1] if cfg.frontend == "vision_stub" and "patches" in batch \
        else 0


def _embed_inputs(params, cfg, batch):
    """Token embeddings, with the vision stub's patches prefixed.  Returns
    (x (B, n_prefix + S, d), n_prefix)."""
    device = params["embed"].device
    x = embed_lookup(params["embed"], batch["tokens"].to(device))
    n_prefix = _n_prefix(cfg, batch)
    if n_prefix:
        x = torch.cat([batch["patches"].to(device, x.dtype), x], dim=1)
    return x, n_prefix


def lm_forward(params, cfg, batch, *, mode, cache, kv_len=None, remat=False):
    """Embed (``batch["tokens"]`` (B, S) and, for the VLM, its ``patches``),
    run every block (filling ``cache``; None in ``train``, where ``remat``
    rematerializes each unit body), final norm.  Returns (x, n_prefix)."""
    x, n_prefix = _embed_inputs(params, cfg, batch)
    x = constrain(x, ("batch", "act_seq", "act_embed"))
    positions = torch.arange(x.shape[1], device=x.device)
    if mode == "decode":
        positions = positions + kv_len
    x = _backbone(params, cfg, x, positions, mode=mode, cache=cache, kv_len=kv_len, remat=remat)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), n_prefix


def lm_loss(params, cfg, batch, *, remat=True):
    """Next-token cross-entropy over the text region of ``batch["tokens"]``
    (B, S) (after the VLM's patch prefix), with the optional
    ``batch["loss_mask"]`` (B, S) weighting the predicted tokens (the
    reference's ``lm_loss``; ``remat`` as its)."""
    x, n_prefix = lm_forward(params, cfg, batch, mode="train", cache=None, remat=remat)
    tokens = batch["tokens"].to(x.device)
    logits = _logits(params, cfg, x[:, n_prefix:-1, :])
    mask = batch.get("loss_mask")
    mask = None if mask is None else mask.to(x.device)[:, 1:]
    return softmax_cross_entropy(logits, tokens[:, 1:], mask)


def lm_prefill(params, cfg, batch, *, max_len: int | None = None):
    """Full-sequence pass that also emits the serving cache.  Returns
    (logits of the last position (B, 1, V), cache with attention entries
    right-padded to ``max_len``, default the prompt's length, patches
    included)."""
    b, s = batch["tokens"].shape
    s += _n_prefix(cfg, batch)
    cache = distribute_tree(lambda init: init_lm_cache(init, cfg, b, max(max_len or s, s)),
                            lm_cache_axes(cfg), params["embed"])
    x, _ = lm_forward(params, cfg, batch, mode="prefill", cache=cache)
    return _logits(params, cfg, x[:, -1:, :]), cache


def pad_cache_to(cache, max_len: int):
    """Right-pad the sequence axis of the attention entries of a cache (axis
    2 under the layer-stacked ``blocks``, else 1) to ``max_len``."""
    def pad(tree, axis):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = pad(val, axis)
            elif key in _SEQ_CACHE_KEYS and val.shape[axis] < max_len:
                shape = list(val.shape)
                shape[axis] = max_len - shape[axis]
                out[key] = torch.cat([val, val.new_zeros(shape)], dim=axis)
            else:
                out[key] = val
        return out
    return {"blocks": pad(cache["blocks"], 2), "tail": pad(cache["tail"], 1)}


def lm_decode_step(params, cfg, token, cache, kv_len: int):
    """token: (B, 1) int; kv_len: count of filled cache entries (the VLM's
    patches included).  Writes the step's entries into ``cache``.  Returns
    (logits (B, 1, V), cache)."""
    x, _ = lm_forward(params, cfg, {"tokens": token}, mode="decode", cache=cache,
                      kv_len=int(kv_len))
    return _logits(params, cfg, x), cache


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch, keeping the dtype; bfloat16 arrays (ml_dtypes) are
    carried bit for bit through uint16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _meta_params(cfg) -> dict:
    if cfg.family == "audio":
        from .whisper import init_whisper
        return init_whisper(Init(torch.device("meta")), cfg)
    return init_lm(Init(torch.device("meta")), cfg)


def params_from_numpy(cfg, tree, device) -> dict:
    """Load the reference's ``init_lm`` pytree (``init_whisper``'s for the
    audio family), as nested dicts of numpy arrays, into the port's
    parameters on ``device``.  Every leaf keeps its dtype; the tree must have
    the structure and shapes of :func:`init_lm` (``init_whisper``) under
    some setting of the layout flags (:mod:`.flags`): the current one is
    tried first, and an error names what it expected."""
    names = ("fused_w13", "head_sharded_layouts")
    current = tuple(flags.get(n) for n in names)
    settings = [current] + [v for v in itertools.product((True, False), repeat=2)
                            if v != current]
    first = None
    for values in settings:
        with flags.flags(**dict(zip(names, values))):
            want = _meta_params(cfg)
        try:
            return tree_from_numpy(want, tree, device)
        except ValueError as e:
            first = first or e
    raise first


def tree_from_numpy(want: dict, tree, device, path: str = "") -> dict:
    """``tree`` (nested dicts of numpy arrays) as tensors on ``device``,
    checked leaf by leaf against ``want`` (the same structure of ``meta``
    tensors): keys, shapes and dtypes must match."""
    if isinstance(want, dict):
        if not isinstance(tree, dict) or set(tree) != set(want):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path or 'params'}: expected keys {sorted(want)}, got {got}")
        return {k: tree_from_numpy(want[k], tree[k], device, f"{path}/{k}") for k in want}
    out = _to_torch(tree, torch.device(device))
    if tuple(out.shape) != tuple(want.shape) or out.dtype != want.dtype:
        raise ValueError(f"{path}: expected {want.dtype} {tuple(want.shape)}, "
                         f"got {out.dtype} {tuple(out.shape)}")
    return out
