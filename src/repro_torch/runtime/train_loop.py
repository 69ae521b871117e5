"""Fault-tolerant training loop (the reference's ``repro.runtime.train_loop``).

* **resume** — on start, restore the newest complete checkpoint (params and
  optimizer state) and continue from its step; the counter-based token
  stream gives the resumed run the batches an uninterrupted one would see,
  so the resume is bit for bit;
* **periodic and final checkpoints** — a save every ``save_every`` steps
  (on a thread with ``async_save``); SIGTERM/SIGINT (a preemption notice)
  ends the loop after the step in flight, with a final blocking save;
* **straggler telemetry** — the step-time median test of
  :class:`~repro_torch.runtime.metrics.StepTimer`;
* **failure containment** — a step that raises is retried after restoring
  the last checkpoint, up to ``max_step_retries`` times; then it re-raises.

Sharded runs: with parameters and optimizer state as ``DTensor``s on a
``DeviceMesh`` (the step of :func:`repro_torch.launch.steps.make_train_step`),
every rank runs the loop; a save is gathered and written by rank 0
(:class:`~repro_torch.checkpoint.CheckpointManager`), and
``shardings=(param_shardings, opt_shardings)`` puts each restored leaf
straight onto its sharding on resume, whatever mesh saved it, as the
reference's ``try_resume`` does.  Without ``shardings`` a restored leaf
takes the current state's placement.  A step's time includes its device
work: the loop synchronizes the card before it stops the clock, where the
reference blocks until the metrics are ready.
"""

from __future__ import annotations

import dataclasses
import signal
from pathlib import Path
from typing import Any, Callable

import torch

from ..checkpoint import CheckpointManager
from ..optim import OptState
from .metrics import MetricsLogger, StepTimer

__all__ = ["TrainLoopConfig", "TrainLoop"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    save_every: int = 100
    keep_checkpoints: int = 3
    log_every: int = 10
    async_save: bool = True
    max_step_retries: int = 1


def _block(metrics: dict) -> None:
    """Wait for the card to finish the step that produced ``metrics``."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                torch.cuda.synchronize(v.device)
            return


class TrainLoop:
    def __init__(
        self,
        step_fn: Callable,          # (params, opt_state, batch) -> (params, opt_state, metrics)
        batch_fn: Callable,         # step -> batch
        params: Any,
        opt_state: Any,
        config: TrainLoopConfig,
        ckpt_dir: str | Path,
        metrics_path: str | Path | None = None,
        shardings: tuple | None = None,     # (param shardings, OptState of shardings)
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.params = params
        self.opt_state = opt_state
        self.config = config
        self.ckpt = CheckpointManager(ckpt_dir, keep=config.keep_checkpoints)
        self.logger = MetricsLogger(metrics_path, print_every=config.log_every)
        self.timer = StepTimer()
        self.shardings = shardings
        self.start_step = 0
        self._interrupted = False

    # ------------------------------------------------------------------ #
    def _state(self) -> dict:
        """The checkpointed tree: the optimizer state under the reference's
        leaf names (``opt_state/0`` the step, ``1`` mu, ``2`` nu, ``3``
        master)."""
        o = self.opt_state
        return {"params": self.params, "opt_state": o.tree() if isinstance(o, OptState) else o}

    def try_resume(self) -> int:
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0
        sh = None
        if self.shardings is not None:
            p_sh, o_sh = self.shardings
            sh = {"params": p_sh, "opt_state": o_sh.tree() if isinstance(o_sh, OptState) else o_sh}
        restored = self.ckpt.restore(latest, self._state(), sh)
        self.params = restored["params"]
        o = restored["opt_state"]
        self.opt_state = OptState.from_tree(o) if isinstance(self.opt_state, OptState) else o
        self.start_step = latest
        print(f"[resume] restored checkpoint at step {latest}", flush=True)
        return latest

    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._interrupted = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:      # not the main thread
                pass

    # ------------------------------------------------------------------ #
    def run(self) -> dict:
        self._install_signal_handlers()
        self.try_resume()
        step = self.start_step
        last_metrics: dict = {}
        while step < self.config.total_steps and not self._interrupted:
            batch = self.batch_fn(step)
            retries = 0
            while True:
                try:
                    with self.timer:
                        self.params, self.opt_state, metrics = self.step_fn(
                            self.params, self.opt_state, batch)
                        _block(metrics)
                    break
                except Exception:
                    retries += 1
                    if retries > self.config.max_step_retries:
                        raise
                    if self.ckpt.latest_step() is not None:
                        self.try_resume()
                        step = self.start_step
                        batch = self.batch_fn(step)
                    print(f"[retry] step {step} failed; retry {retries}", flush=True)
            step += 1
            last_metrics = {k: float(v) for k, v in metrics.items()}
            last_metrics["step_time_s"] = self.timer.history[-1]
            if self.timer.is_straggling:
                last_metrics["straggler_flag"] = 1.0
            self.logger.log(step, last_metrics)
            if step % self.config.save_every == 0:
                self.ckpt.save(step, self._state(), blocking=not self.config.async_save)
        # final (preemption or completion) checkpoint
        self.ckpt.save(step, self._state(), blocking=True)
        self.ckpt.wait()
        return {"final_step": step, "interrupted": self._interrupted, **last_metrics}
