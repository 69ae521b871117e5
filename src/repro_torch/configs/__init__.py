"""Model configurations of the ten architectures of the LM zoo."""

from .base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES, TrainConfig, shape_applicable,
)
from .registry import ARCH_IDS, all_configs, get_config, get_smoke_config  # noqa: F401
