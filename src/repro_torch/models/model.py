"""The Model facade (``repro.models.model``) for the LM zoo's serving path.

``build_model(cfg, device=None)`` returns a :class:`Model` with the
reference's names:

* ``init_params(seed=0)`` — parameters drawn from a seeded
  ``torch.Generator`` on the model's device;
* ``prefill(params, batch, max_len=None)`` — (last-position logits, cache);
* ``decode_step(params, token, cache, kv_len)`` — (logits, cache), writing
  the step into ``cache``;
* ``init_cache(batch, max_len)``.

The model runs on the card unless ``device`` names another; on CPU tensors
every kernel op runs its plain PyTorch version.  The whisper branch waits.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import blocks, lm
from .common import Init

__all__ = ["Model", "build_model", "count_params"]


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

    def init_params(self, seed: int = 0) -> dict:
        gen = None
        if self.device.type != "meta":
            gen = torch.Generator(device=self.device).manual_seed(seed)
        return lm.init_lm(Init(self.device, gen), self.cfg)

    @torch.inference_mode()
    def prefill(self, params, batch, max_len: int | None = None):
        return lm.lm_prefill(params, self.cfg, batch, max_len=max_len)

    @torch.inference_mode()
    def decode_step(self, params, token, cache, kv_len: int):
        return lm.lm_decode_step(params, self.cfg, token, cache, kv_len)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return lm.init_lm_cache(Init(self.device), self.cfg, batch, max_len)


def build_model(cfg: ModelConfig, device: str | torch.device | None = None) -> Model:
    """The LM's serving handle; raises for what is not ported yet."""
    if cfg.family == "audio":
        raise NotImplementedError("whisper (encoder-decoder) is not ported yet")
    for tok in set(cfg.pattern()):
        blocks.check_supported(cfg, tok)
    return Model(cfg, resolve_device(device))


def count_params(model: Model) -> int:
    """Parameter count, from shapes built on the ``meta`` device (nothing is
    allocated)."""
    params = lm.init_lm(Init(torch.device("meta")), model.cfg)

    def total(tree):
        return sum(total(v) if isinstance(v, dict) else math.prod(v.shape)
                   for v in tree.values())
    return total(params)
