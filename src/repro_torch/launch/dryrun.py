"""The multi-pod dry run (``repro.launch.dryrun``): per-device memory, cost
and collectives of every arch x shape x mesh cell, with an H100 roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Records: ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``, in the
reference's schema (``benchmarks/roofline_table.py`` and
``scripts/make_roofline_table.py`` read them as they are).

What runs.  The reference lowers each cell with XLA on 256 or 512 host
placeholder devices and reads the per-device program.  The port runs its
own step — the train, prefill or decode function that
:mod:`repro_torch.launch.steps`'s step makers return — as one rank of a
256- or 512-rank world of the ``fake`` process-group backend (no peer
exists; a collective returns at once):

* ``init_device_mesh`` builds the production mesh (16 x 16 over
  ``("data", "model")``, or 2 x 16 x 16 with ``"pod"`` outermost);
* the parameters, optimizer state, batch and cache are ``DTensor``s placed
  by their resolved ``NamedSharding.placements``, each local shard an empty
  tensor on the ``meta`` device (nothing is allocated, no card is used);
* the forwards' ``constrain`` calls, at the reference's call sites, pin the
  activations' placements; where ``DTensor`` has no sharding rule for an
  operation on these placements, its arguments are replicated and the
  operation runs replicated (counted under ``"fallbacks"``);
* a ``TorchDispatchMode`` below ``DTensor`` sees the local operations of
  this one device: matrix products (and the B3/B4 kernel calls, priced at
  their products over every query-key pair and scan chunk), bytes read and
  written, the ``_c10d_functional`` collectives with their mesh groups, and
  the live local tensors (``temp_bytes``: their peak, less what the step
  returns).  A train step's microbatch loop, and the sLSTM's time loop, is
  traced once and counted as many times as it runs, as the reference's
  analyzer multiplies a scan body by its trip count.

The roofline's constants are the H100's published peaks
(:mod:`repro_torch.launch.roofline`): every record is a model of the
port's per-device program, not a measurement.  The dry run needs a process
of its own (one default process group a process): it refuses to run where a
real group exists.
"""

from __future__ import annotations

import argparse
import collections
import contextvars
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from .. import trace_hooks
from ..kernels import sharded
from ..configs import (ARCH_IDS, SHAPES, ShapeConfig, TrainConfig, get_config, get_smoke_config,
                       shape_applicable)
from .cost import StepCost
from .roofline import HW, group_link, roofline_from_cost

__all__ = ["MICROBATCHES", "train_config", "lower_cell", "trace_step", "fake_world",
           "device_mesh", "reference_problems", "METHOD", "FLOPS_RTOL", "main"]

# per-arch microbatch counts for the train cells (global batch 256); the
# reference's
MICROBATCHES = {
    "kimi-k2-1t-a32b": 16,
    "qwen3-moe-235b-a22b": 16,
    "qwen3-32b": 8,
    "qwen3-14b": 8,
    "llava-next-mistral-7b": 8,
    "zamba2-7b": 8,
    "minicpm3-4b": 8,
    "internlm2-1.8b": 4,
    "xlstm-350m": 4,
    "whisper-tiny": 4,
}

METHOD = ("model, not a measurement: the port's own train/prefill/decode step traced as one "
          "rank of a fake-backend process group over DTensors on the production mesh, "
          "local shards on the meta device; flops are the local products (B3/B4 over every "
          "query-key pair and scan chunk), bytes the local operations' inputs plus outputs, "
          "collectives the _c10d_functional calls; terms at the H100 SXM5's published peaks "
          "(989 TFLOP/s bf16, 3.35 TB/s HBM3, NVLink 450 GB/s in a node, NDR 50 GB/s across)")

_KINDS = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}
_MATMULS = {"mm", "bmm", "addmm", "baddbmm"}
# loops whose body is traced once and counted n times (a step's microbatches;
# the sLSTM's time steps over local shards)
_TRIP_COUNTED = {"microbatches", "slstm.time"}
_NO_TRAFFIC = {"detach", "alias", "lift_fresh", "empty", "empty_like", "empty_strided",
               "new_empty", "new_empty_strided", "_local_scalar_dense", "sym_size",
               "sym_stride", "sym_numel"}


def train_config(arch: str) -> TrainConfig:
    """The train cells' config: the reference's microbatches, no float32
    master copy (remat is the model's: :func:`trace_step`'s ``remat``)."""
    return TrainConfig(microbatches=MICROBATCHES.get(arch, 8), master_fp32=False, remat=False)


# ------------------------------------------------------------------ world
def fake_world(size: int) -> None:
    """Make this process rank 0 of a ``fake``-backend world of ``size``
    ranks (a fake world of another size is replaced); raise where a real
    process group exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"the dry run needs a process of its own: this one is in a "
                f"{dist.get_backend()!r} world of {dist.get_world_size()} ranks")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def device_mesh(shape: tuple, names: tuple):
    """A CPU ``DeviceMesh`` of ``shape`` over a fake world of its size."""
    import math
    from torch.distributed.device_mesh import init_device_mesh
    fake_world(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _group_links(mesh) -> dict:
    import torch.distributed as dist
    out = {}
    for d in range(mesh.ndim):
        pg = mesh.get_group(d)
        out[pg.group_name] = group_link(dist.get_process_group_ranks(pg))
    return out


# ------------------------------------------------------------------ tracer
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtensor_cls():
    from torch.distributed.tensor import DTensor
    return DTensor


def _replicated(a, keep_batch: bool = False):
    """``a`` (or each ``DTensor`` in a list) replicated over every mesh axis,
    or, with ``keep_batch``, over every axis but those splitting dim 0."""
    from torch.distributed.tensor import Replicate, Shard
    if hasattr(a, "device_mesh"):
        pl = [p if keep_batch and isinstance(p, Shard) and p.dim == 0 else Replicate()
              for p in a.placements]
        return a.redistribute(a.device_mesh, pl)
    if isinstance(a, (list, tuple)):
        return type(a)(_replicated(x, keep_batch) for x in a)
    return a


def _replicated_dtensor(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim, run_check=False)


def _model_scope() -> str:
    """The innermost function of the port's models or kernels on the
    stack (the backward pass has none)."""
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith(("repro_torch.models", "repro_torch.kernels", "repro_torch.optim")):
            return f"{mod.rsplit('.', 1)[-1]}.{f.f_code.co_name}"
        f = f.f_back
    return "backward"


class _Trace(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts one device's local operations under ``DTensor`` (see the
    module docstring); also the ``trace_hooks`` recorder (loops, kernels)."""

    def __init__(self, links: dict, scopes: bool = True, detail: int = 0):
        super().__init__()
        self.links = links
        self.cost = StepCost()
        self.mult = 1
        self.fallbacks: dict = {}
        self.loops: list = []
        self.want_scopes = scopes
        self.detail = detail
        self.scopes: dict = collections.defaultdict(lambda: [0.0, 0.0, set(), []])
        self._passing = False
        self._in_kernel = False
        self._live: dict = {}
        self.live = 0
        self.peak = 0
        self._since_sweep = 0

    # -------------------------------------------------- trace_hooks side
    def loop(self, name: str, n: int):
        if name in _TRIP_COUNTED:       # one traced body, counted n times
            self.mult *= n
            try:
                yield 0
            finally:
                self.mult //= n
            return
        for i in range(n):
            self.loops.append(f"{name}.{i}")
            try:
                yield i
            finally:
                self.loops.pop()

    def kernel(self, name: str, flops: float, inputs, make_outputs):
        inputs = tuple(inputs)
        if not any(hasattr(t, "device_mesh") for t in inputs):
            outs = make_outputs()
            self._count(name, float(flops), inputs, outs)
            return outs
        mesh = next(t.device_mesh for t in inputs if hasattr(t, "device_mesh"))
        inputs = tuple(t if hasattr(t, "device_mesh") else _replicated_dtensor(t, mesh)
                       for t in inputs)
        placed, out_placements = sharded.ALIGN[name](inputs)
        local_in = sharded.local_operands(name, placed)
        self._in_kernel = True
        try:
            outs = make_outputs()
        finally:
            self._in_kernel = False
        single = not isinstance(outs, tuple)
        outs = (outs,) if single else outs
        DTensor = _dtensor_cls()
        mesh = placed[0].device_mesh
        made = []
        for o, pl in zip(outs, out_placements):
            local = list(o.shape)
            for size, p in zip(mesh.shape, pl):
                if hasattr(p, "dim"):
                    local[p.dim] //= size
            loc = torch.empty(local, dtype=o.dtype, device=local_in[0].device)
            made.append(DTensor.from_local(loc, mesh, pl, run_check=False, shape=o.shape,
                                           stride=o.stride()))
        self._count(name, _KERNEL_FLOPS[name](local_in), local_in, [m.to_local() for m in made])
        for m in made:
            self._track(m.to_local())
        return made[0] if single else tuple(made)

    # -------------------------------------------------- dispatch side
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, _dtensor_cls()) for t in types):
            if self._passing:
                return NotImplemented
            self._passing = True
            try:
                with self:
                    try:
                        return func(*args, **kwargs)
                    except Exception:   # no sharding rule for these placements
                        if func._schema.is_mutable:
                            raise
                        key = str(func.overloadpacket)
                        self.fallbacks[key] = self.fallbacks.get(key, 0) + 1
                        try:
                            return func(*_replicated(args, keep_batch=True), **kwargs)
                        except Exception:
                            return func(*_replicated(args), **kwargs)
            finally:
                self._passing = False
        out = func(*args, **kwargs)
        if self._in_kernel:
            return out
        flat = torch.utils._pytree.tree_leaves((args, kwargs, out))
        tensors = [t for t in flat if isinstance(t, torch.Tensor)]
        from torch._subclasses.fake_tensor import FakeTensor
        if any(isinstance(t, FakeTensor) or t.device.type != "meta" for t in tensors):
            return out          # DTensor's own shape propagation and index bookkeeping
        name = func.overloadpacket.__name__
        ns = func.namespace
        outs = [t for t in torch.utils._pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        if ns.startswith("_c10d_functional"):
            kind = _KINDS.get(name.rstrip("_"))
            if kind is not None:
                group = next(a for a in reversed(args) if isinstance(a, str))
                self.cost.add_collective(kind, self.links.get(group, "ib"),
                                         self.mult * sum(map(_nbytes, outs)))
            for t in outs:
                self._track(t)
            return out
        ins = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if func.is_view or name in _NO_TRAFFIC or not ins:
            for t in outs:
                self._track(t)
            return out
        flops = _op_flops(name, args, outs)
        self._count(name, flops, ins, outs)
        for t in outs:
            self._track(t)
        return out

    def _count(self, name: str, flops: float, ins, outs) -> None:
        nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.cost.add_op(self.mult * flops, self.mult * nbytes)
        if self.want_scopes:
            scope = _model_scope()
            loop = ".".join(lp.rsplit(".", 1)[0] + ".*" for lp in self.loops)
            key = f"{loop}.{scope}" if loop else scope
            row = self.scopes[key]
            row[0] += self.mult * nbytes
            row[1] += self.mult * flops
            row[2].add(tuple(self.loops))
            if self.detail:
                row[3].append((self.mult * sum(map(_nbytes, outs)), name,
                               [tuple(t.shape) for t in outs][:2]))
                if len(row[3]) > 4 * self.detail:
                    row[3].sort(reverse=True)
                    del row[3][self.detail:]

    # -------------------------------------------------- live memory
    def _track(self, t: torch.Tensor) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef
        try:
            st = t.untyped_storage()
        except Exception:
            return
        ref = StorageWeakRef(st)
        if ref.cdata in self._live:
            return
        self._live[ref.cdata] = (ref, st.nbytes())
        self.live += st.nbytes()
        self._since_sweep += 1
        if self.live > self.peak or self._since_sweep >= 256:
            self.sweep()            # a new peak counts only storages still alive
        self.peak = max(self.peak, self.live)

    def sweep(self) -> None:
        self._since_sweep = 0
        for key in [k for k, (ref, _) in self._live.items() if ref.expired()]:
            self.live -= self._live.pop(key)[1]


def _op_flops(name: str, args, outs) -> float:
    """A matrix product's 2 x output elements x contracted length (the zoo
    runs no convolution op: its causal conv is shifted adds)."""
    if name in _MATMULS:
        a = args[0] if name in ("mm", "bmm") else args[1]
        return 2.0 * outs[0].numel() * a.shape[-1]
    return 0.0


# ------------------------------------------------------------------ kernels
def _flash_flops(local) -> float:
    """B3's two products over every (query, key) pair, as the plain version
    and the reference's chunked attention compute them."""
    q, k, v = local
    b, hq, sq, d = q.shape
    return 2.0 * b * hq * sq * k.shape[2] * (d + v.shape[-1])


def _ssd_flops(local) -> float:
    """The chunked scan's products over whole (chunk, chunk) blocks, as the
    plain version and the reference's chunked scan compute them: C B^T, its
    product with x, C h and the state update, a chunk and head."""
    x, b_ = local[0], local[3]
    bt, s, h, p = x.shape
    q = min(_SSD_CHUNK.get(), s)
    n = b_.shape[3]
    return 2.0 * bt * h * (-(-s // q)) * (q * q * n + q * q * p + 2 * q * n * p)


_KERNEL_FLOPS = {"flash_fwd": _flash_flops, "ssd_scan": _ssd_flops}
_SSD_CHUNK = contextvars.ContextVar("ssd_chunk", default=64)   # the traced model's chunk


# ------------------------------------------------------------------ placing
def _tmap(f, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tmap(f, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return f(tree, *rest)


def _local_shape(shape, mesh, placements) -> list:
    local = list(shape)
    for size, p in zip(mesh.shape, placements):
        if hasattr(p, "dim"):
            local[p.dim] //= size
    return local


def _place(sharding, spec):
    """A ``DTensor`` of ``spec``'s shape and dtype at ``sharding``'s
    placements, its local shard empty on the meta device."""
    from torch.distributed.tensor import DTensor
    mesh, pl = sharding.mesh, sharding.placements
    shape = tuple(spec.shape)
    loc = torch.empty(_local_shape(shape, mesh, pl), dtype=spec.dtype, device="meta")
    glob = torch.empty(shape, dtype=spec.dtype, device="meta")
    return DTensor.from_local(loc, mesh, pl, run_check=False, shape=glob.shape,
                              stride=glob.stride())


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif tree is not None:
        yield tree


def _local_bytes(tree) -> int:
    total = 0
    for t in _leaves(tree):
        if isinstance(t, torch.Tensor):
            total += _nbytes(t.to_local() if hasattr(t, "device_mesh") else t)
        elif hasattr(t, "tree"):          # an optimizer state
            total += _local_bytes(t.tree()) if callable(t.tree) else _local_bytes(t.tree)
    return total


def _opt_tree(state) -> dict:
    return {"step": state.step, "mu": state.mu, "nu": state.nu,
            **({"master": state.master} if state.master is not None else {})}


# ------------------------------------------------------------------ one cell
def trace_step(cfg, shape: ShapeConfig, mesh_shape: tuple, mesh_names: tuple,
               microbatches: int = 1, scopes: bool = True, detail: int = 0,
               remat: bool = False) -> dict:
    """Trace one step of ``cfg`` at ``shape`` as one device of a mesh of
    ``mesh_shape`` over ``mesh_names`` (this process joins a fake world of
    its size).  ``remat`` builds the model with it (the golden cells are
    lowered without; with it a train step's backward counts each unit's
    recomputed forward).  Returns ``{"memory", "cost" (a StepCost),
    "timing", "fallbacks", "outputs", "trace"}``."""
    from ..models.model import build_model
    from ..optim import OptState
    from . import steps

    mesh = device_mesh(mesh_shape, mesh_names)
    model = build_model(cfg, device="meta", remat=remat)
    specs, axes = model.input_records(shape)
    t0 = time.perf_counter()
    p_sh = steps.param_shardings(model, mesh)
    meta_params = model.init_params()
    params = _tmap(_place, p_sh, meta_params)
    kv_len = None
    if shape.kind == "train":
        tcfg = TrainConfig(microbatches=microbatches, master_fp32=False, remat=False)
        fn, (_, o_sh, b_sh), optimizer = steps.make_train_step(model, mesh, tcfg, specs, axes)
        o_meta = optimizer.init(meta_params)
        opt = OptState(step=_place(o_sh.step, o_meta.step),
                       mu=_tmap(_place, o_sh.mu, o_meta.mu),
                       nu=_tmap(_place, o_sh.nu, o_meta.nu),
                       master=None if o_meta.master is None
                       else _tmap(_place, o_sh.master, o_meta.master))
        batch = {k: _place(b_sh[k], specs[k]) for k in specs}
        args = (params, _opt_tree(opt), batch)
        run = lambda: fn(params, opt, batch)                          # noqa: E731
    elif shape.kind == "prefill":
        fn, (_, b_sh) = steps.make_prefill_step(model, mesh, specs, axes)
        batch = {k: _place(b_sh[k], specs[k]) for k in specs}
        args = (params, batch)
        run = lambda: fn(params, batch)                               # noqa: E731
    else:
        b = shape.global_batch
        fn, (_, tok_sh, c_sh) = steps.make_decode_step(model, mesh, b, shape.seq_len)
        cache = _tmap(_place, c_sh, model.init_cache(b, shape.seq_len))
        token = _place(tok_sh, specs["token"])
        kv_len = shape.seq_len - 1
        args = (params, token, cache, torch.empty((), dtype=torch.int32, device="meta"))
        run = lambda: fn(params, token, cache, kv_len)                # noqa: E731
    t_place = time.perf_counter() - t0

    tr = _Trace(_group_links(mesh), scopes=scopes, detail=detail)
    token_ = trace_hooks.RECORDER.set(tr)
    chunk_ = _SSD_CHUNK.set(cfg.ssm.chunk if cfg.ssm is not None else 64)
    t0 = time.perf_counter()
    try:
        with tr:
            out = run()
            if shape.kind == "train":      # at the step's declared output layouts
                new_p, new_o, metrics = out
                out = (new_p, _opt_tree(new_o), metrics)
        tr.sweep()
    finally:
        trace_hooks.RECORDER.reset(token_)
        _SSD_CHUNK.reset(chunk_)
    t_trace = time.perf_counter() - t0

    out_leaves = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], f"{path}/{k}" if path else k)
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                walk(v, f"{path}/{i}" if path else str(i))
        elif isinstance(tree, torch.Tensor):
            loc = tree.to_local() if hasattr(tree, "device_mesh") else tree
            out_leaves.append({"name": path, "shape": list(tree.shape),
                               "dtype": str(tree.dtype).replace("torch.", ""),
                               "placements": str(tuple(getattr(tree, "placements", ()))),
                               "local_bytes": _nbytes(loc)})
    walk(out, "")
    arg_bytes = sum(_local_bytes(a) for a in args)
    out_bytes = sum(o["local_bytes"] for o in out_leaves)
    temp = max(0, tr.peak - out_bytes)
    return {"memory": {"argument_bytes": int(arg_bytes), "output_bytes": int(out_bytes),
                       "temp_bytes": int(temp),
                       "peak_estimate_bytes": int(arg_bytes + out_bytes + temp)},
            "cost": tr.cost, "timing": {"place_s": t_place, "trace_s": t_trace},
            "fallbacks": dict(tr.fallbacks), "outputs": out_leaves, "trace": tr}


def _cost_record(cost: StepCost) -> dict:
    return {"flops_per_device": cost.flops,
            "bytes_per_device": cost.bytes_accessed,
            "collective_bytes_per_device": cost.collective_bytes,
            "collective_counts": {k: float(v) for k, v in cost.collective_counts.items()},
            "collective_bytes_by_kind": {k: float(v)
                                         for k, v in cost.collective_bytes_by_kind.items()},
            "collective_bytes_by_link": {f"{k}/{link}": float(v) for (k, link), v
                                         in cost.collective_bytes_by_link.items()}}


def lower_cell(arch: str, shape_name: str, multi_pod: bool, return_trace: bool = False,
               smoke: bool = False, remat: bool = False):
    """Trace one cell on the production mesh (16 x 16, or 2 x 16 x 16 with
    ``multi_pod``); ``smoke`` takes the arch's SMOKE config (a quick check
    of the machinery, not a cell of the sweep); ``remat`` as
    :func:`trace_step`'s (off, as the golden cells are lowered).  Returns
    the record (and the trace, for the perf probe, with ``return_trace``)."""
    from ..models.model import analytic_flops
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "skipped",
               "reason": reason}
        return (rec, None) if return_trace else rec
    mesh_shape, names = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                         else ((16, 16), ("data", "model")))
    m = MICROBATCHES.get(arch, 8) if shape.kind == "train" else 1
    res = trace_step(cfg, shape, mesh_shape, names, microbatches=m, scopes=return_trace,
                     detail=8 if return_trace else 0, remat=remat)
    chips = 1
    for s in mesh_shape:
        chips *= s
    rl = roofline_from_cost(res["cost"], chips, analytic_flops(cfg, shape))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
           **({"config": "smoke"} if smoke else {}), "method": METHOD, "remat": remat, "hardware": HW,
           "memory": res["memory"], "cost": _cost_record(res["cost"]),
           "roofline": rl.as_dict(), "timing": res["timing"],
           "fallbacks": res["fallbacks"], "outputs": res["outputs"], "status": "ok"}
    if shape.kind == "train":
        rec["microbatches"] = m
    return (rec, res["trace"]) if return_trace else rec


#: XLA's CPU memory analysis counts a step's outputs with an 8-byte entry a
#: leaf of their tuple; the port's output bytes are the tensors' alone
XLA_TUPLE_ENTRY_BYTES = 8
#: per-device flops of the port against the reference's (PERF.md §2)
FLOPS_RTOL = 0.05


def reference_problems(mem: dict, flops: float, model_flops: float, ref: dict,
                       prefill_outputs: list | None = None) -> list:
    """What differs between a port cell (``mem`` its ``memory`` record) and
    the reference's record ``ref`` of the same cell (``memory``, ``hlo_cost``
    or ``flops_per_device``, ``model_flops``, the list of ``outputs``):
    argument and output bytes must be equal (the reference's outputs less
    its tuple table), ``model_flops`` equal within 1e-12 relative,
    per-device flops within :data:`FLOPS_RTOL`.  A prefill's cache comes
    back in the decode layout, which XLA's unconstrained outputs do not
    share (ROADMAP §C): given the cell's ``prefill_outputs`` records, its
    output bytes must be theirs instead."""
    out = []
    if mem["argument_bytes"] != ref["memory"]["argument_bytes"]:
        out.append(f"argument_bytes {mem['argument_bytes']} != {ref['memory']['argument_bytes']}")
    want_out = ref["memory"]["output_bytes"] - XLA_TUPLE_ENTRY_BYTES * len(ref["outputs"])
    if prefill_outputs is not None:
        want_out = sum(o["local_bytes"] for o in prefill_outputs)
    if mem["output_bytes"] != want_out:
        out.append(f"output_bytes {mem['output_bytes']} != {want_out}")
    if abs(model_flops - ref["model_flops"]) > 1e-12 * abs(ref["model_flops"]):
        out.append(f"model_flops {model_flops!r} != {ref['model_flops']!r}")
    want = ref["hlo_cost"]["flops_per_device"] if "hlo_cost" in ref else ref["flops_per_device"]
    if abs(flops / want - 1.0) > FLOPS_RTOL:
        out.append(f"flops_per_device {flops:.6g} against {want:.6g} ({flops / want:.4f}x)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="arch=all shape=all mesh=both")
    ap.add_argument("--outdir", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' SMOKE configs (a quick check, not the sweep)")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize each unit body in the train cells (the reference's "
                         "default lowering; the golden cells are lowered without)")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" or args.all else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" or args.all else [args.shape]
    meshes = [False, True] if args.mesh == "both" or args.all else [args.mesh == "multi"]
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    n_ok = n_skip = n_fail = 0
    t_all = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
                path = outdir / f"{tag}.json"
                if args.skip_existing and path.exists():
                    prev = json.loads(path.read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[skip-existing] {tag}")
                        continue
                try:
                    rec = lower_cell(arch, shape, multi, smoke=args.smoke, remat=args.remat)
                except Exception as e:  # a failure here is a fault of the sharded program
                    rec = {"arch": arch, "shape": shape, "mesh": "multi" if multi else "single",
                           "status": "failed", "error": f"{type(e).__name__}: {e}"[:2000],
                           "traceback": traceback.format_exc()[-4000:]}
                path.write_text(json.dumps(rec, indent=1))
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_fail += st == "failed"
                if st == "ok":
                    r = rec["roofline"]
                    print(f"[ok]   {tag:50s} trace={rec['timing']['trace_s']:6.1f}s "
                          f"compute={r['compute_s']:.4g}s memory={r['memory_s']:.4g}s "
                          f"collective={r['collective_s']:.4g}s dom={r['dominant']:10s} "
                          f"mfu_bound={r['mfu_bound']:.3f} "
                          f"mem={rec['memory']['peak_estimate_bytes'] / 2**30:8.2f}GiB/dev",
                          flush=True)
                elif st == "skipped":
                    print(f"[skip] {tag:50s} {rec['reason'][:60]}", flush=True)
                else:
                    print(f"[FAIL] {tag:50s} {rec['error'][:160]}", flush=True)
    print(f"\nsummary: ok={n_ok} skipped={n_skip} failed={n_fail} "
          f"in {time.perf_counter() - t_all:.1f} s (a model at the H100's published peaks, "
          "not a measurement)")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
