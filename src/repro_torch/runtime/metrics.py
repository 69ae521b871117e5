"""Step timing, straggler detection and metrics logging (the reference's
``repro.runtime.metrics``)."""

from __future__ import annotations

import json
import time
from collections import deque
from pathlib import Path

__all__ = ["StepTimer", "MetricsLogger"]


class StepTimer:
    """Per-step wall-time EMA and straggler flagging: a step slower than
    ``threshold`` x the median of the past ``window`` steps, ``patience``
    steps in a row, flags the host."""

    def __init__(self, ema: float = 0.9, threshold: float = 2.0,
                 patience: int = 3, window: int = 50):
        self.ema_factor = ema
        self.threshold = threshold
        self.patience = patience
        self.ema_s: float | None = None
        self.history: deque[float] = deque(maxlen=window)
        self._slow_streak = 0
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.record(time.perf_counter() - self._t0)

    def record(self, dt: float) -> None:
        # against the median of past steps: an EMA absorbs the straggler
        # itself and de-flags after one slow step
        med = self.median()
        if med > 0 and dt > self.threshold * med:
            self._slow_streak += 1
        else:
            self._slow_streak = 0
        self.history.append(dt)
        self.ema_s = dt if self.ema_s is None else (
            self.ema_factor * self.ema_s + (1 - self.ema_factor) * dt)

    @property
    def is_straggling(self) -> bool:
        return self._slow_streak >= self.patience

    def median(self) -> float:
        if not self.history:
            return 0.0
        s = sorted(self.history)
        return s[len(s) // 2]


class MetricsLogger:
    """JSONL metrics sink and a stdout summary every ``print_every`` steps."""

    def __init__(self, path: str | Path | None = None, print_every: int = 10):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
        self.print_every = print_every

    def log(self, step: int, metrics: dict) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        if self.path:
            with self.path.open("a") as f:
                f.write(json.dumps(rec) + "\n")
        if step % self.print_every == 0:
            kv = " ".join(f"{k}={float(v):.4g}" for k, v in metrics.items())
            print(f"[step {step:6d}] {kv}", flush=True)
