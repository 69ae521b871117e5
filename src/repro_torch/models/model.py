"""The Model facade (``repro.models.model``) for the LM zoo's serving and
training paths.

``build_model(cfg, device=None, *, remat=True)`` returns a :class:`Model`
with the reference's names:

* ``init_params(seed=0, host=False)`` — parameters drawn from a seeded
  ``torch.Generator`` on the model's device (on ``meta``: shapes only), or
  with ``host=True`` from threefry on the host (the same weights on every
  machine; slow: for smoke sizes);
* ``loss(params, batch)`` — the scalar train loss (float32), differentiable
  through autograd: B3 and B4 run under their autograd Functions.  With
  ``remat`` (the reference's default) and gradients enabled, each unit body
  of the layer loop (whisper: each encoder and decoder layer) runs under
  ``torch.utils.checkpoint`` (non-reentrant): its activations are not kept
  for the backward, which recomputes the body's forward, as the reference's
  ``jax.checkpoint`` does; the tail blocks stay outside;
* ``prefill(params, batch, max_len=None)`` — (last-position logits, cache);
* ``decode_step(params, token, cache, kv_len)`` — (logits, cache), writing
  the step into ``cache`` (prefill and decode never remat);
* ``init_cache(batch, max_len)``;
* ``param_axes()`` / ``cache_axes()`` — the logical-sharding trees of the
  parameters and the cache (same structure; one name or None a dim), which
  :mod:`repro_torch.parallel.sharding` resolves against a mesh;
* ``input_records(shape)`` — the reference's ``input_specs``: ``(specs,
  axes)`` for every model input of a shape cell, ``specs`` as
  :class:`~repro_torch.models.common.TensorSpec` (shape, dtype) records in
  place of ``ShapeDtypeStruct``, decode's ``kv_len`` included;
* ``input_specs(shape)`` — the same inputs (``kv_len`` aside) as empty
  tensors on the ``meta`` device, which ingest traces.

``count_params``, ``active_params`` and ``analytic_flops`` (6·N·D training,
2·N·D inference, N the parameters a token touches) count on the ``meta``
device, as the reference's roofline and partitioner do.

The decoder-only LMs run ``repro_torch.models.lm``, the audio family
(whisper) ``repro_torch.models.whisper``.  The model runs on the card
unless ``device`` names another; on CPU tensors every kernel op runs its
plain PyTorch version.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from . import blocks, lm, whisper
from .common import Init, KeyStream, TensorSpec

__all__ = ["Model", "build_model", "count_params", "active_params", "analytic_flops"]


def _serving(fn):
    """Run a serving entry point under ``torch.inference_mode``, or under
    ``torch.no_grad`` when the parameters are ``DTensor``s (the dry run's
    sharded trace: inference tensors do not take ``DTensor`` views)."""
    @functools.wraps(fn)
    def run(self, params, *args, **kwargs):
        sharded = hasattr(params.get("embed"), "device_mesh")
        with torch.no_grad() if sharded else torch.inference_mode():
            return fn(self, params, *args, **kwargs)
    return run


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    remat: bool = True

    @property
    def _audio(self) -> bool:
        return self.cfg.family == "audio"

    def init_params(self, seed: int = 0, host: bool = False) -> dict:
        gen = None
        if host:
            gen = KeyStream(seed)
        elif self.device.type != "meta":
            gen = torch.Generator(device=self.device).manual_seed(seed)
        init = Init(self.device, gen)
        return whisper.init_whisper(init, self.cfg) if self._audio else lm.init_lm(init, self.cfg)

    def loss(self, params, batch) -> torch.Tensor:
        """The train loss of ``batch`` (``tokens`` (B, S), and for whisper
        ``audio_embed`` (B, encoder_seq, d); optionally ``loss_mask``)."""
        if self._audio:
            return whisper.whisper_loss(params, self.cfg, batch, remat=self.remat)
        return lm.lm_loss(params, self.cfg, batch, remat=self.remat)

    @_serving
    def prefill(self, params, batch, max_len: int | None = None):
        if self._audio:
            return whisper.whisper_prefill(params, self.cfg, batch, max_len=max_len)
        return lm.lm_prefill(params, self.cfg, batch, max_len=max_len)

    @_serving
    def decode_step(self, params, token, cache, kv_len: int):
        if self._audio:
            return whisper.whisper_decode_step(params, self.cfg, token, cache, kv_len)
        return lm.lm_decode_step(params, self.cfg, token, cache, kv_len)

    def init_cache(self, batch: int, max_len: int) -> dict:
        init = Init(self.device)
        if self._audio:
            return whisper.init_whisper_cache(init, self.cfg, batch, max_len)
        return lm.init_lm_cache(init, self.cfg, batch, max_len)

    def param_axes(self) -> dict:
        return whisper.whisper_axes(self.cfg) if self._audio else lm.lm_axes(self.cfg)

    def cache_axes(self) -> dict:
        return whisper.whisper_cache_axes(self.cfg) if self._audio else lm.lm_cache_axes(self.cfg)

    def input_records(self, shape: ShapeConfig) -> tuple[dict, dict]:
        """(specs, logical axes) of the model inputs of one shape cell (the
        reference's ``input_specs``): for train and prefill ``tokens`` (B,
        S) int32, and ``audio_embed`` (B, encoder_seq, d) bf16 for whisper;
        for the VLM ``patches`` (B, n_patches, d) bf16 and ``tokens`` (B,
        S - n_patches); for decode ``token`` (B, 1) and the scalar
        ``kv_len``."""
        b, s = shape.global_batch, shape.seq_len
        i32, bf16 = torch.int32, torch.bfloat16
        if shape.kind == "decode":
            return ({"token": TensorSpec((b, 1), i32), "kv_len": TensorSpec((), i32)},
                    {"token": ("batch", None), "kv_len": ()})
        if self._audio:
            return ({"audio_embed": TensorSpec((b, self.cfg.encoder_seq, self.cfg.d_model), bf16),
                     "tokens": TensorSpec((b, s), i32)},
                    {"audio_embed": ("batch", None, None), "tokens": ("batch", None)})
        if self.cfg.family == "vlm":
            return ({"patches": TensorSpec((b, self.cfg.n_patches, self.cfg.d_model), bf16),
                     "tokens": TensorSpec((b, s - self.cfg.n_patches), i32)},
                    {"patches": ("batch", None, None), "tokens": ("batch", None)})
        return {"tokens": TensorSpec((b, s), i32)}, {"tokens": ("batch", None)}

    def input_specs(self, shape: ShapeConfig) -> dict:
        """The inputs of :meth:`input_records` as empty ``meta`` tensors,
        decode's ``kv_len`` (an int argument of ``decode_step``) aside."""
        specs, _ = self.input_records(shape)
        meta = torch.device("meta")
        return {k: torch.empty(r.shape, dtype=r.dtype, device=meta)
                for k, r in specs.items() if k != "kv_len"}


def build_model(cfg: ModelConfig, device: str | torch.device | None = None, *,
                remat: bool = True) -> Model:
    """The model's serving handle (``remat``: the train loss rematerializes
    each unit body); raises for what is not ported yet."""
    for tok in set("ec" if cfg.family == "audio" else cfg.pattern()):
        blocks.check_supported(cfg, tok)
    return Model(cfg, resolve_device(device), remat)


def count_params(model: Model) -> int:
    """Parameter count, from shapes built on the ``meta`` device (nothing is
    allocated)."""
    params = Model(model.cfg, torch.device("meta")).init_params()

    def total(tree):
        return sum(total(v) if isinstance(v, dict) else math.prod(v.shape)
                   for v in tree.values())
    return total(params)


def active_params(cfg: ModelConfig) -> int:
    """Parameters a token touches (MoE: its top-k experts, not all of them)."""
    total = count_params(Model(cfg, torch.device("meta")))
    if cfg.moe is None:
        return total
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    expert_p = 3 * cfg.d_model * cfg.moe.d_ff_expert
    n_moe_layers = cfg.pattern().count("a")
    return total - n_moe_layers * expert_p * e + n_moe_layers * expert_p * k


def analytic_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for an inference forward (N =
    active parameters, D = tokens)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active_params(cfg) * tokens
