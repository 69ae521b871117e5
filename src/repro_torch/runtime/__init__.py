"""The fault-tolerant training loop and its metrics (the reference's
``repro.runtime``)."""

from .metrics import MetricsLogger, StepTimer
from .train_loop import TrainLoop, TrainLoopConfig

__all__ = ["MetricsLogger", "StepTimer", "TrainLoop", "TrainLoopConfig"]
