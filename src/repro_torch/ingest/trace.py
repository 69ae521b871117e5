"""Trace a registry architecture into per-operation cost records, shapes only.

The reference lowers the model under ``jax.jit`` and parses XLA's optimized
HLO (``repro.ingest.trace`` and ``repro.utils.hlo``); torch has no such
program text.  The port records the model's own torch calls instead:
``trace_model("whisper-tiny")`` builds the model on the ``meta`` device
(nothing is allocated, the counterpart of ``jax.eval_shape`` and
``ShapeDtypeStruct``), runs its prefill under a
:class:`torch.overrides.TorchFunctionMode` and emits one
:class:`~repro_torch.ingest.records.InstrRecord` per compute call, in the
order the calls ran (a topological order), under the reference's rules:

* only matrix products carry operations (``torch.utils.flop_counter``'s
  formulas: the reference's ``flops_only`` prices only dot and convolution);
  every other record carries 0 and its output bytes;
* views, reshapes, transposes, expands, dtype casts and layout copies fold
  into their producer (the reference's passthrough opcodes), and calls on
  constants alone (factories, rotary tables) are constants, as XLA folds
  them;
* operands are the producer records; each weight's bytes are billed once,
  to the first live record that reads it (a slice of a stacked weight is
  billed as its own bytes: one layer's share, as the reference bills a
  scanned stack by 1/trips an instance);
* a kernel call (B3 ``flash_fwd``, B4 ``ssd_scan``) is one record that
  names the kernel, with the kernel's own operation count
  (:func:`repro_torch.trace_hooks.kernel`);
* a Python loop of the model (:func:`repro_torch.trace_hooks.loop`: the
  layer loops, the sLSTM's time steps) stays unrolled while the records
  before it plus its trip count times its body's size fit the node budget
  (4096), as the reference's ``_walk_while`` decides; the body's size is
  the first iteration's records with a nested loop counted as one.  A loop
  over the budget becomes one ``loop`` record with the summed operations,
  the billed weights and, as its output, the bytes that records after it
  read from it;
* records whose output does not reach the logits are dropped, as XLA drops
  dead code (the prefill's cache writes).

The same calls run on the CPU and on the card, so the same records, and the
same graph hash, come out of both.  ``kind="train"`` traces ``model.loss``
forward over the prefill's inputs, as the reference lowers ``model.loss``
(no backward pass: neither package traces one).
"""

from __future__ import annotations

import dataclasses
import time

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from .. import trace_hooks
from ..configs import ShapeConfig, get_config, get_smoke_config
from ..models.model import build_model
from .records import HloProgram, InstrRecord

__all__ = ["TraceResult", "trace_model", "record", "NODE_BUDGET", "TRACE_KINDS"]

TRACE_KINDS = ("prefill", "train")
NODE_BUDGET = 4096          # the reference's analyze_hlo_instructions default

#: calls that only relabel their input (the reference's passthrough opcodes:
#: bitcast, reshape, transpose, broadcast, convert, copy)
_VIEWS = frozenset({
    "view", "view_as", "reshape", "reshape_as", "transpose", "permute", "t", "T", "mT",
    "expand", "expand_as", "broadcast_to", "unsqueeze", "squeeze", "flatten", "unflatten",
    "movedim", "swapaxes", "contiguous", "clone", "detach", "float", "double", "half",
    "bfloat16", "to", "type", "type_as", "repeat_interleave", "split", "chunk", "unbind",
    "narrow", "select", "getitem", "alias",
})
#: views that take a part of their input: a weight read through one is billed
#: the part's bytes
_PART_VIEWS = frozenset({"getitem", "split", "chunk", "unbind", "narrow", "select"})
#: calls whose output depends on nothing but their arguments' shapes
_FACTORIES = frozenset({
    "arange", "zeros", "ones", "full", "empty", "zeros_like", "ones_like", "full_like",
    "empty_like", "new_zeros", "new_ones", "new_full", "new_empty", "tensor", "as_tensor",
})
#: matrix products: their operations are counted
_MATMULS = frozenset({"matmul", "mm", "bmm", "einsum", "linear", "addmm", "baddbmm",
                      "tensordot", "conv1d", "conv2d"})
_REFLECTED = frozenset({"add", "sub", "mul", "truediv", "matmul", "pow"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _opcode(func) -> tuple[str, bool]:
    """(the call's opcode, whether it writes its first argument in place)."""
    name = getattr(func, "__name__", "")
    if name == "__get__":     # a property such as Tensor.T
        name = getattr(getattr(func, "__self__", None), "__name__", name)
    inplace = name == "__setitem__" or (name.endswith("_") and not name.startswith("_"))
    op = name.strip("_")
    if op.startswith("r") and op[1:] in _REFLECTED:
        op = op[1:]
    return op or "call", inplace


def _basic_index(idx) -> bool:
    """True for an index of ints, slices, None and Ellipsis (a view)."""
    items = idx if isinstance(idx, tuple) else (idx,)
    return all(i is None or i is Ellipsis or isinstance(i, (int, slice)) for i in items)


@dataclasses.dataclass(frozen=True)
class _Weight:
    key: tuple
    nbytes: float


@dataclasses.dataclass(frozen=True)
class _Val:
    deps: frozenset = frozenset()     # producer record names
    weights: tuple = ()               # weights not yet billed on this path
    var: bool = True                  # False for a constant (no input, weight or record)


_CONST = _Val(var=False)
_INPUT = _Val()


@dataclasses.dataclass
class _Raw:
    """A record before finalization."""
    name: str
    opcode: str
    flops: float
    out_bytes: float
    operands: set
    weights: list
    reads: list                       # (tensor id, bytes, producer) of each input read
    aggregate: bool = False


@dataclasses.dataclass
class _Frame:
    """One Python loop being recorded."""
    name: str
    trips: int
    start: int                        # records before the loop
    own: int = 0                      # records of its first iteration outside nested loops
    nested: int = 0                   # loops started in its first iteration
    decided: bool = False
    agg: _Raw | None = None           # set when the loop is aggregated
    folded: set = dataclasses.field(default_factory=set)
    child_notes: dict = dataclasses.field(default_factory=dict)


class Recorder(TorchFunctionMode):
    """Records the torch calls of one shapes-only forward pass.  Use
    :func:`record`; the model's hooks reach it through
    :data:`repro_torch.trace_hooks.RECORDER`."""

    def __init__(self, params: dict, inputs, node_budget: int = NODE_BUDGET):
        super().__init__()
        self.node_budget = node_budget
        self.vals: dict[int, _Val] = {}
        self.keep: list = []              # every tensor keyed by id, kept alive
        self.raws: list[_Raw] = []
        self.alias: dict[str, str] = {}   # folded record -> its aggregate
        self.frames: list[_Frame] = []
        self.notes: dict[str, int] = {}
        self.warnings: dict[str, int] = {}
        self.n_calls = 0
        self._counter = 0
        self._suspended = 0

        def walk(tree, path):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    self._set(v, _Val(weights=(_Weight(path + (k,), _nbytes(v)),)))
        walk(params, ("params",))
        for t in tree_leaves(inputs):
            if isinstance(t, torch.Tensor):
                self._set(t, _INPUT)

    # ------------------------------------------------------------------ #
    def _set(self, t: torch.Tensor, val: _Val) -> None:
        self.vals[id(t)] = val
        self.keep.append(t)

    def _resolve(self, name: str) -> str:
        while name in self.alias:
            name = self.alias[name]
        return name

    def _val(self, t: torch.Tensor) -> _Val:
        val = self.vals.get(id(t))
        if val is None:
            self.warnings["untracked_tensor"] = self.warnings.get("untracked_tensor", 0) + 1
            return _CONST
        return val

    def _merge(self, tensors) -> tuple[frozenset, list, list, bool]:
        deps, weights, reads, seen, var = set(), [], [], set(), False
        for t in tensors:
            v = self._val(t)
            var = var or v.var
            for d in v.deps:
                d = self._resolve(d)
                deps.add(d)
                reads.append((id(t), _nbytes(t), d))
            for w in v.weights:
                if w.key not in seen:
                    seen.add(w.key)
                    weights.append(w)
        return frozenset(deps), weights, reads, var

    def _aggregating(self) -> _Frame | None:
        return next((f for f in self.frames if f.agg is not None), None)

    def _emit(self, opcode: str, flops: float, out_bytes: float, tensors) -> str:
        deps, weights, reads, _ = self._merge(tensors)
        agg = self._aggregating()
        if agg is not None:
            self._fold(agg, _Raw("", opcode, flops, 0.0, set(deps), weights, reads))
            return agg.agg.name
        name = f"{opcode}.{self._counter}"
        self._counter += 1
        self.raws.append(_Raw(name, opcode, float(flops), float(out_bytes), set(deps), weights,
                              reads))
        if self.frames and not self.frames[-1].decided:
            self.frames[-1].own += 1
        return name

    def _fold(self, frame: _Frame, raw: _Raw) -> None:
        """Add a record of the loop's body to its aggregate record."""
        agg = frame.agg
        agg.flops += raw.flops
        agg.weights.extend(raw.weights)
        agg.operands |= {d for d in map(self._resolve, raw.operands)
                         if d not in frame.folded and d != agg.name}
        for tid, nb, prod in raw.reads:
            prod = self._resolve(prod)
            if prod not in frame.folded and prod != agg.name:
                agg.reads.append((tid, nb, prod))

    # ------------------------------------------------------------------ #
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op, inplace = _opcode(func)
        if op in _MATMULS and not self._suspended:
            with FlopCounterMode(display=False) as fc:
                out = func(*args, **kwargs)
            flops = float(fc.get_total_flops())
        else:
            out, flops = func(*args, **kwargs), 0.0
        if self._suspended:
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        inplace = inplace and bool(ins) and args[0] is ins[0]
        if not inplace and not outs:
            return out                 # metadata: shape, dtype, device, ...
        self.n_calls += 1
        if inplace:                    # the mutated tensor takes the new value
            self._set(ins[0], _Val(frozenset({self._emit(op, flops, _nbytes(ins[0]), ins)})))
            return out
        if op in _FACTORIES:
            for t in outs:
                self._set(t, _CONST)
            return out
        if op == "getitem" and not _basic_index(args[1]):
            op = "gather"
        if op in _VIEWS:
            deps, weights, _, var = self._merge(ins)
            for i, t in enumerate(outs):
                ws = weights
                if op in _PART_VIEWS and weights and len(ins) == 1:
                    # the part's share of the weight's own bytes: a cast before
                    # the view does not change what the weight costs to read
                    share = t.numel() / max(ins[0].numel(), 1)
                    ws = [_Weight(w.key + ((op, repr(args[1:]), repr(kwargs), i),),
                                  w.nbytes * share) for w in weights]
                self._set(t, _Val(deps, tuple(ws), var))
            return out
        if not self._merge(ins)[3]:    # a function of constants is a constant
            for t in outs:
                self._set(t, _CONST)
            return out
        name = self._emit(op, flops, sum(_nbytes(t) for t in outs), ins)
        for t in outs:
            self._set(t, _Val(frozenset({name})))
        return out

    # ------------------------------------------------------------------ #
    def kernel(self, name: str, flops: float, inputs, make_outputs):
        self._suspended += 1
        try:
            out = make_outputs()
        finally:
            self._suspended -= 1
        ins = [t for t in tree_leaves(inputs) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.n_calls += 1
        rec = self._emit(name, flops, sum(_nbytes(t) for t in outs), ins)
        for t in outs:
            self._set(t, _Val(frozenset({rec})))
        return out

    def loop(self, name: str, trips: int):
        if self._aggregating() is not None or trips <= 0:
            yield from range(trips)     # inside an aggregated loop: all folds into it
            return
        if self.frames and not self.frames[-1].decided:
            self.frames[-1].nested += 1
        frame = _Frame(name, trips, len(self.raws))
        self.frames.append(frame)
        try:
            for t in range(trips):
                yield t
                if t == 0:
                    self._decide(frame)
        finally:
            self.frames.pop()
            self._close(frame)

    def _decide(self, frame: _Frame) -> None:
        frame.decided = True
        body = max(frame.own + frame.nested, 1)
        if frame.start + frame.trips * body <= self.node_budget:
            return
        # over the budget: fold the first iteration into one aggregate record
        frame.agg = _Raw(f"loop.{self._counter}", "loop", 0.0, 0.0, set(), [], [],
                         aggregate=True)
        self._counter += 1
        body_raws = self.raws[frame.start:]
        del self.raws[frame.start:]
        frame.folded = {r.name for r in body_raws}
        for r in body_raws:
            self.alias[r.name] = frame.agg.name
        for r in body_raws:
            self._fold(frame, r)
        frame.child_notes.clear()      # loops inside it count as part of it

    def _close(self, frame: _Frame) -> None:
        notes = frame.child_notes
        key = "aggregated_loops" if frame.agg is not None else "expanded_loops"
        notes[key] = notes.get(key, 0) + 1
        if frame.agg is not None:
            self.raws.append(frame.agg)
        target = self.frames[-1].child_notes if self.frames else self.notes
        for k, v in notes.items():
            target[k] = target.get(k, 0) + v

    # ------------------------------------------------------------------ #
    def program(self, root: torch.Tensor) -> HloProgram:
        """The live records, in order, with weights billed and aggregate
        outputs priced; ``root`` is the traced function's output."""
        by_name = {r.name: r for r in self.raws}
        live, stack = set(), [self._resolve(d) for d in self._val(root).deps]
        while stack:
            nm = stack.pop()
            if nm not in live:
                live.add(nm)
                stack.extend(self._resolve(o) for o in by_name[nm].operands)
        kept = [r for r in self.raws if r.name in live]
        agg_out = {r.name: 0.0 for r in kept if r.aggregate}
        seen: set = set()
        for r in kept:
            for tid, nb, prod in r.reads:
                prod = self._resolve(prod)
                if prod in agg_out and prod != r.name and (prod, tid) not in seen:
                    seen.add((prod, tid))
                    agg_out[prod] += nb
        for prod in self._val(root).deps:
            if self._resolve(prod) in agg_out:
                agg_out[self._resolve(prod)] += _nbytes(root)
        billed: set = set()
        records = []
        for r in kept:
            pb = 0.0
            for w in r.weights:
                if w.key not in billed:
                    billed.add(w.key)
                    pb += w.nbytes
            records.append(InstrRecord(
                name=r.name, opcode=r.opcode, flops=r.flops,
                out_bytes=agg_out.get(r.name, r.out_bytes), param_bytes=pb,
                operands=tuple(sorted({self._resolve(o) for o in r.operands}))))
        return HloProgram(records, "prefill", self.n_calls, warnings=dict(self.warnings),
                          notes=dict(self.notes))


def record(fn, params: dict, inputs, node_budget: int = NODE_BUDGET) -> HloProgram:
    """Run ``fn()`` (a forward pass over ``params`` and ``inputs``, meta
    tensors) under a :class:`Recorder` and return its records; ``fn``
    returns the tensor whose ancestors are kept."""
    rec = Recorder(params, inputs, node_budget)
    token = trace_hooks.RECORDER.set(rec)
    try:
        with rec:
            root = fn()
    finally:
        trace_hooks.RECORDER.reset(token)
    return rec.program(root)


@dataclasses.dataclass
class TraceResult:
    arch: str
    kind: str
    batch: int
    seq_len: int
    program: HloProgram
    t_build_s: float      # the meta model and its inputs
    t_trace_s: float      # the recorded forward pass and its records


def trace_model(arch: str, *, smoke: bool = True, kind: str = "prefill", batch: int = 1,
                seq_len: int = 16, node_budget: int = NODE_BUDGET) -> TraceResult:
    """Trace one architecture's prefill (logits of the last position), or
    with ``kind="train"`` its train loss forward over the same inputs, on
    the meta device and return its records with the time split."""
    if kind not in TRACE_KINDS:
        raise ValueError(f"kind must be one of {TRACE_KINDS}, got {kind!r}")
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.family == "vlm":
        # the VLM's text length, seq_len - n_patches, must stay positive
        seq_len = max(seq_len, cfg.n_patches + 8)
    t0 = time.perf_counter()
    model = build_model(cfg, device="meta", remat=False)      # as the reference traces it
    params = model.init_params()
    inputs = model.input_specs(ShapeConfig("ingest", seq_len, batch, "prefill"))
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    if kind == "prefill":
        def fwd():
            return model.prefill(params, inputs)[0]
    else:
        def fwd():
            return model.loss(params, inputs)
    program = record(fwd, params, inputs, node_budget)
    return TraceResult(arch=arch, kind=kind, batch=batch, seq_len=seq_len, program=program,
                       t_build_s=t_build, t_trace_s=time.perf_counter() - t0)
