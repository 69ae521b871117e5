"""Model/shape configuration dataclasses (a copy of the reference's
``repro.configs.base``, which the port may not import)."""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["MoEConfig", "SSMConfig", "ModelConfig", "ShapeConfig", "SHAPES",
           "shape_applicable", "TrainConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64          # N
    head_dim: int = 64           # P
    n_groups: int = 1            # G (B/C groups)
    expand: int = 2              # d_inner = expand * d_model
    conv_kernel: int = 4
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qk_norm: bool = False
    attention: str = "gqa"                  # gqa | mla
    # MLA (DeepSeek/MiniCPM3 style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # block pattern for hybrids: e.g. "mmmmmA" tiled over n_layers, where
    # m = mamba2, A = SHARED-weight attention block, a = attention block,
    # s = sLSTM, x = mLSTM.  None -> all-attention ("a" * n_layers).
    block_pattern: Optional[str] = None
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500                 # stub frame count
    cross_attention: bool = False
    frontend: Optional[str] = None          # audio_stub | vision_stub
    n_patches: int = 0                      # vlm stub patch count
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    sub_quadratic: bool = False             # eligible for long_500k
    # citation string from the assignment table
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def pattern(self) -> str:
        if self.block_pattern is None:
            return "a" * self.n_layers
        pat = (self.block_pattern * (self.n_layers // len(self.block_pattern) + 1))
        return pat[: self.n_layers]

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) per the assignment rules."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, ("pure full-attention arch: 512k dense decode is "
                       "outside the cell's intent (sub-quadratic archs only)")
    return True, ""


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer knobs carried alongside the model config (the reference's
    fields).  ``remat`` is read by neither package's step: activation
    rematerialization is ``build_model``'s argument (``remat=True`` by
    default, as the reference's).  ``grad_compression`` is not read by the
    reference's LM step either; the port refuses any value but None, so
    that a config asking for compressed gradients does not train
    uncompressed."""
    microbatches: int = 8
    remat: bool = True
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    max_grad_norm: float = 1.0
    grad_compression: Optional[str] = None   # None | "int8"
    master_fp32: bool = False

    def __post_init__(self):
        if self.grad_compression is not None:
            raise NotImplementedError(
                f"grad_compression={self.grad_compression!r}: the LM train step's data "
                "parallelism does not compress gradients (the reference ignores the field)")
