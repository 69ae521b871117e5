"""Whisper-style encoder-decoder (``repro.models.whisper``): the backbone
only, as in the reference — the conv/mel front end is a stub and the model
takes precomputed frame embeddings (B, encoder_seq, d).

Encoder: bidirectional attention blocks (``e``) over the frames plus a
learned positional table.  Decoder: causal self-attention + cross-attention
blocks (``c``).  Prefill projects each layer's cross K/V once and caches
them beside the self-attention K/V; decode attends over both caches.  The
reference's layer scans become Python loops over per-layer slices of the
stacked parameters, and caches are filled in place (``repro_torch.models.lm``).
``whisper_loss`` is the decoder's next-token cross-entropy, the blocks run
in ``mode="train"`` with no cache.
"""

from __future__ import annotations

import torch

from .. import trace_hooks
from . import blocks
from .common import (Init, distribute_tree, dtype_of, embed_lookup, lift_layers, rms_norm,
                     softmax_cross_entropy)
from .lm import _layer, _store, rematerialized

__all__ = ["init_whisper", "whisper_axes", "init_whisper_cache", "whisper_cache_axes",
           "whisper_loss", "whisper_prefill", "whisper_decode_step"]


def init_whisper(init: Init, cfg):
    dt = dtype_of(cfg)
    return {
        "embed": init.normal((cfg.vocab_size, cfg.d_model), 0.02, dt),
        "enc_pos": init.normal((cfg.encoder_seq, cfg.d_model), 0.02, dt),
        "enc_norm": init.full((cfg.d_model,), 1.0, torch.float32),
        "final_norm": init.full((cfg.d_model,), 1.0, torch.float32),
        "encoder": blocks.init_block(init.stacked(cfg.encoder_layers), cfg, "e"),
        "decoder": blocks.init_block(init.stacked(cfg.n_layers), cfg, "c"),
    }


def whisper_axes(cfg):
    return {
        "embed": ("vocab", "embed_nofsdp"),
        "enc_pos": (None, "embed_nofsdp"),
        "enc_norm": (None,),
        "final_norm": (None,),
        "encoder": lift_layers(blocks.block_axes(cfg, "e")),
        "decoder": lift_layers(blocks.block_axes(cfg, "c")),
    }


def init_whisper_cache(init: Init, cfg, batch: int, max_len: int):
    """Per decoder layer (stacked): self-attention K/V of ``max_len`` and
    the cross K/V over the encoder's ``encoder_seq`` frames."""
    return blocks.init_block_cache(init.stacked(cfg.n_layers), cfg, "c", batch, max_len)


def whisper_cache_axes(cfg):
    return lift_layers(blocks.block_cache_axes(cfg, "c"))


def _encode(params, cfg, audio_embed, remat=False):
    x = audio_embed.to(params["embed"].dtype) + params["enc_pos"][None]
    positions = torch.arange(x.shape[1], device=x.device)

    def body(layer):
        return lambda x: blocks.block_forward(_layer(params["encoder"], layer), cfg, "e", x,
                                              positions, mode="train")[0]
    for layer in trace_hooks.loop("encoder", cfg.encoder_layers):
        x = rematerialized(body(layer), remat)(x)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _decode_stack(params, cfg, x, positions, enc_out, *, mode, cache, kv_len, remat=False):
    def body(layer):
        def run(x):
            slot = None if cache is None else _layer(cache, layer)
            x, nc = blocks.block_forward(_layer(params["decoder"], layer), cfg, "c", x,
                                         positions, mode=mode,
                                         cache=slot if mode == "decode" else None,
                                         kv_len=kv_len, enc_out=enc_out)
            _store(slot, nc)
            return x
        return run
    for layer in trace_hooks.loop("decoder", cfg.n_layers):
        x = rematerialized(body(layer), remat and mode == "train")(x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def whisper_loss(params, cfg, batch, *, remat=True):
    """Encode ``batch["audio_embed"]`` (B, encoder_seq, d), run the decoder
    over ``batch["tokens"]`` (B, S) and return the next-token
    cross-entropy (the reference's ``whisper_loss``; with ``remat`` each
    encoder and decoder layer is rematerialized)."""
    device = params["embed"].device
    tokens = batch["tokens"].to(device)
    enc_out = _encode(params, cfg, batch["audio_embed"].to(device), remat)
    x = _decode_stack(params, cfg, embed_lookup(params["embed"], tokens),
                      torch.arange(tokens.shape[1], device=device), enc_out, mode="train",
                      cache=None, kv_len=None, remat=remat)
    return softmax_cross_entropy(x[:, :-1, :] @ params["embed"].T, tokens[:, 1:])


def whisper_prefill(params, cfg, batch, *, max_len: int | None = None):
    """Encode ``batch["audio_embed"]`` (B, encoder_seq, d), then run the
    decoder over ``batch["tokens"]`` (B, S).  Returns (logits of the last
    position (B, 1, V), cache with self-attention entries of ``max_len``,
    default S)."""
    device = params["embed"].device
    tokens = batch["tokens"].to(device)
    enc_out = _encode(params, cfg, batch["audio_embed"].to(device))
    b, s = tokens.shape
    cache = distribute_tree(lambda init: init_whisper_cache(init, cfg, b, max(max_len or s, s)),
                            whisper_cache_axes(cfg), params["embed"])
    x = _decode_stack(params, cfg, embed_lookup(params["embed"], tokens),
                      torch.arange(s, device=device), enc_out, mode="prefill", cache=cache,
                      kv_len=None)
    return x[:, -1:, :] @ params["embed"].T, cache


def whisper_decode_step(params, cfg, token, cache, kv_len: int):
    """token: (B, 1) int; kv_len: filled self-attention entries.  Writes the
    step into ``cache``.  Returns (logits (B, 1, V), cache)."""
    token = token.to(params["embed"].device)
    positions = torch.arange(1, device=token.device) + int(kv_len)
    x = _decode_stack(params, cfg, embed_lookup(params["embed"], token), positions, None,
                      mode="decode", cache=cache, kv_len=int(kv_len))
    return x @ params["embed"].T, cache
