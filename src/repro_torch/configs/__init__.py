"""Model configurations of the architectures the port builds."""

from .base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES, TrainConfig, shape_applicable,
)
from .registry import ARCH_IDS, get_config, get_smoke_config  # noqa: F401
