"""Microbatch pipeline parallelism: a RESPECT cut run stage after stage
(the reference's ``repro.parallel.pipeline``).

The GPipe schedule, as the reference's: ``n_micro + n_stages - 1`` ticks;
at tick ``t`` stage ``s`` runs microbatch ``t - s`` and hands its output to
stage ``s + 1``; the bubble fraction is ``(n_stages - 1) / ticks``.  RESPECT
minimizes the bottleneck stage time, the other factor of the pipeline's
throughput.  Each block is ``blocks.block_forward(..., mode="train")``, so an
attention block runs B3 on the card.

The reference's ``pipe`` mesh axis maps to ``devices``: one torch device a
stage, by default every stage on the resolved card.  On the card each stage
has its own CUDA stream; a hand-off is an event recorded on the producing
stage's stream that the consuming stage's stream waits on, and the tensor
handed on is ``record_stream``-ed on the consumer's stream, so the caching
allocator cannot reuse its memory under a kernel still reading it.  A stage
on another device receives its input by ``.to(device, non_blocking=True)``.

A deliberate difference from the reference: its SPMD program executes every
padded block slot and every bubble tick and masks the results away
(``jnp.where``); the port executes only the real (stage, microbatch, block)
work.  The outputs are the same, and B3's launch count is ``n_layers x
n_micro`` a forward.

The forward is differentiable, as the reference's is under ``jax.grad``:
autograd runs each operation's backward on the stream of its forward, and
with ``remat`` (and gradients on) every block runs under
``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of the scan
body.  Embedding and the LM head stay outside the pipe, as there: hidden
states are the only tensors that cross stages.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..models import blocks as blocks_mod
from ..models.common import Init
from ..models.lm import tree_from_numpy
from ..optim import tree_map

__all__ = ["PipelineRunner"]


class PipelineRunner:
    """Uniform-block (``"a" * L`` patterns) pipeline executor.

    ``stages``: per-stage lists of block indices (from the partitioner);
    only contiguous covers are valid (monotone schedules are).  ``devices``:
    one device a stage (default: every stage on the card)."""

    def __init__(self, cfg, stages: list[list[int]], n_micro: int, remat: bool = True,
                 devices=None):
        if cfg.block_pattern not in (None, "a"):
            raise NotImplementedError("pipeline runner covers uniform-attn "
                                      "patterns; hybrids use the pjit path")
        self.cfg = cfg
        self.stages = stages
        self.n_stages = len(stages)
        self.n_micro = n_micro
        self.remat = remat
        self.l_max = max(len(s) for s in stages)
        flat = [b for s in stages for b in s]
        if flat != sorted(flat) or len(flat) != cfg.n_layers:
            raise ValueError("stage assignment must be a contiguous cover")
        if devices is None:
            devices = [resolve_device(None)] * self.n_stages
        self.devices = [resolve_device(d) for d in devices]
        if len(self.devices) != self.n_stages:
            raise ValueError(f"{len(self.devices)} devices for {self.n_stages} stages")

    @property
    def ticks(self) -> int:
        return self.n_micro + self.n_stages - 1

    @property
    def bubble_fraction(self) -> float:
        return (self.n_stages - 1) / self.ticks

    def _valid(self) -> torch.Tensor:
        valid = np.zeros((self.n_stages, self.l_max), np.bool_)
        for s, blks in enumerate(self.stages):
            valid[s, : len(blks)] = True
        return torch.from_numpy(valid)

    # ------------------------------------------------------------------ #
    # parameters: (n_stages, l_max, ...) stacked block params + validity
    # ------------------------------------------------------------------ #
    def init_params(self, generator=None) -> dict:
        """Stacked ``(n_stages, l_max, ...)`` block parameters on the first
        stage's device, drawn from ``generator`` (a ``torch.Generator`` on
        that device, or a host :class:`~repro_torch.models.common.KeyStream`),
        and the ``(n_stages, l_max)`` ``valid`` mask (on the host)."""
        init = Init(self.devices[0], generator, lead=(self.n_stages * self.l_max,))
        flat = blocks_mod.init_block(init, self.cfg, "a")
        stacked = tree_map(lambda a: a.view(self.n_stages, self.l_max, *a.shape[1:]), flat)
        return {"blocks": stacked, "valid": self._valid()}

    def params_from_numpy(self, tree: dict) -> dict:
        """The reference's ``init_params`` tree (nested dicts of numpy
        arrays: ``blocks`` stacked ``(n_stages, l_max, ...)`` and ``valid``)
        as the port's parameters on the first stage's device; keys, shapes
        and dtypes are checked against :meth:`init_params`'s."""
        want = blocks_mod.init_block(Init(torch.device("meta"), lead=(self.n_stages, self.l_max)),
                                     self.cfg, "a")
        valid = np.asarray(tree["valid"], dtype=np.bool_)
        if not np.array_equal(valid, self._valid().numpy()):
            raise ValueError("valid mask does not match the runner's stages")
        return {"blocks": tree_from_numpy(want, tree["blocks"], self.devices[0], "blocks"),
                "valid": torch.from_numpy(valid.copy())}

    # ------------------------------------------------------------------ #
    def _stage_params(self, params: dict, s: int) -> list:
        """Stage ``s``'s real block slots (slot trees on its device)."""
        dev = self.devices[s]
        valid = params["valid"][s].tolist()
        return [tree_map(lambda a: a[s, i].to(dev, non_blocking=True), params["blocks"])
                for i, ok in enumerate(valid) if ok]

    def _block(self, p, x, positions):
        y, _ = blocks_mod.block_forward(p, self.cfg, "a", x, positions, mode="train")
        return y

    def _stage_fn(self, slots: list, x, positions):
        """Run one stage's real block slots over ``x``."""
        remat = self.remat and torch.is_grad_enabled()
        for p in slots:
            if remat:
                x = checkpoint(self._block, p, x, positions, use_reentrant=False)
            else:
                x = self._block(p, x, positions)
        return x

    def _setup(self, params, x_embedded):
        if x_embedded.shape[0] != self.n_micro:
            raise ValueError(f"expected {self.n_micro} microbatches, got {x_embedded.shape[0]}")
        s_len = x_embedded.shape[2]
        slots = [self._stage_params(params, s) for s in range(self.n_stages)]
        positions = [torch.arange(s_len, device=d) for d in self.devices]
        return slots, positions

    # ------------------------------------------------------------------ #
    def forward(self, params: dict, x_embedded: torch.Tensor) -> torch.Tensor:
        """``x_embedded`` (n_micro, B_mb, S, d), hidden states after the
        embedding, on the first stage's device.  Returns (n_micro, B_mb, S,
        d) after all stages, on the last stage's device, by the GPipe tick
        schedule (see the module docstring)."""
        slots, positions = self._setup(params, x_embedded)
        n_stages, n_micro = self.n_stages, self.n_micro
        cuda = [d.type == "cuda" for d in self.devices]
        caller = {d: torch.cuda.current_stream(d) for d, c in zip(self.devices, cuda) if c}
        streams = [torch.cuda.Stream(device=d) if c else None
                   for d, c in zip(self.devices, cuda)]
        for dev, stream in zip(self.devices, streams):
            if stream is not None:   # x and the stage's weights come from the caller's stream
                stream.wait_stream(caller[dev])
        acts: dict = {}      # (stage, microbatch) -> (output, event or None)
        for t in range(self.ticks):
            for s in range(n_stages):
                m = t - s
                if not 0 <= m < n_micro:
                    continue                  # a bubble: nothing to run
                if s == 0:
                    inp, ev = x_embedded[m], None
                else:
                    inp, ev = acts.pop((s - 1, m))
                if streams[s] is None:
                    acts[(s, m)] = (self._stage_fn(slots[s], inp.to(self.devices[s]),
                                                   positions[s]), None)
                    continue
                with torch.cuda.stream(streams[s]):
                    if ev is not None:
                        streams[s].wait_event(ev)
                    if inp.device.type == "cuda":
                        inp.record_stream(streams[s])
                    inp = inp.to(self.devices[s], non_blocking=True)
                    y = self._stage_fn(slots[s], inp, positions[s])
                    done = torch.cuda.Event()
                    done.record(streams[s])
                acts[(s, m)] = (y, done)
        outs = []
        for m in range(n_micro):
            y, ev = acts.pop((n_stages - 1, m))
            if ev is not None:
                cur = caller[self.devices[-1]]
                cur.wait_event(ev)
                y.record_stream(cur)
            outs.append(y)
        return torch.stack(outs)

    def sequential_forward(self, params: dict, x_embedded: torch.Tensor) -> torch.Tensor:
        """Reference path: the same parameters and per-microbatch block
        calls, no pipeline and no extra streams (for equivalence tests)."""
        slots, positions = self._setup(params, x_embedded)
        outs = []
        for m in range(self.n_micro):
            x = x_embedded[m]
            for s in range(self.n_stages):
                x = self._stage_fn(slots[s], x.to(self.devices[s]), positions[s])
            outs.append(x)
        return torch.stack(outs)
