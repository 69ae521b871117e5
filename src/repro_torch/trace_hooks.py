"""Hooks through which model and kernel code tell the ingest recorder
(:mod:`repro_torch.ingest.trace`) what its torch calls do not show: a Python
loop of the model (so that a loop too long to unroll becomes one record, as
the reference's HLO walker aggregates a ``while``), and a kernel call (one
record that names the kernel, with the kernel's own operation count).

Outside a trace both are transparent: :func:`loop` is ``range`` and
:func:`kernel` returns ``make_outputs()``.  The recorder of the current
context is a :class:`contextvars.ContextVar`, set only while
``repro_torch.ingest.trace.record`` runs.
"""

from __future__ import annotations

import contextvars

__all__ = ["RECORDER", "loop", "kernel"]

#: the active recorder, or None outside a trace
RECORDER: contextvars.ContextVar = contextvars.ContextVar("repro_torch_recorder", default=None)


def loop(name: str, n: int):
    """``range(n)`` for a Python loop of the model named ``name``."""
    rec = RECORDER.get()
    return range(n) if rec is None else rec.loop(name, n)


def kernel(name: str, flops: float, inputs, make_outputs):
    """The outputs of a kernel call: ``make_outputs()`` (tensors of the
    right shapes, on the meta device while tracing), recorded as one
    operation ``name`` of ``flops`` reading ``inputs`` when a trace runs."""
    rec = RECORDER.get()
    return make_outputs() if rec is None else rec.kernel(name, flops, inputs, make_outputs)
