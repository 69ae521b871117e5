"""The LM zoo's step makers (the reference's ``repro.launch.steps``).

``make_train_fn(model, tcfg, optimizer)`` returns the step
``(params, opt_state, batch) -> (params, opt_state, metrics)``:

* the batch is split into ``tcfg.microbatches`` equal slices along its first
  axis; each slice's loss is differentiated with autograd (B3 and B4 run
  under their autograd Functions) and its gradients are summed in float32,
  then divided by the count, as the reference's ``lax.scan`` over
  microbatches does; with one microbatch the gradients keep each
  parameter's dtype, as ``jax.value_and_grad`` gives them;
* a parameter the loss does not reach gets a zero gradient (the reference's
  gradient pytree has every leaf);
* global-norm clipping at ``tcfg.max_grad_norm``, then the optimizer's
  update;
* metrics ``loss`` (the microbatches' mean), ``grad_norm`` (before
  clipping) and ``step`` (the optimizer's count after the update), as
  tensors on the parameters' device.

Parameters are a nested dict of tensors that do not require grad; the step
returns new ones.  ``torch.profiler.record_function`` ranges ``lm.forward``
(each microbatch's loss), ``lm.backward`` (its gradients, and their sum)
and ``lm.optimizer`` (clip and update) split a profiled step.

The sharded step makers take a mesh (an abstract one or a ``DeviceMesh``,
:mod:`repro_torch.parallel.sharding`):

* ``param_shardings``, ``cache_shardings``, ``batch_shardings`` and
  ``opt_shardings`` resolve the model's logical axes against the mesh, with
  shapes from ``meta``-device inits (nothing allocated); the optimizer's
  moments and master copies mirror their parameters' shardings and its
  step is replicated.  They work on any mesh, the reference's 256- and
  512-chip ones included.
* ``make_train_step``, ``make_prefill_step`` and ``make_decode_step``
  return the step and its input shardings; the step is the single-device
  one (``make_train_fn``, ``Model.prefill``, ``Model.decode_step``).  On a
  ``DeviceMesh`` it takes ``DTensor``s at those shardings
  (:func:`repro_torch.parallel.sharding.shard_tree`) and runs under
  ``implicit_replication``, so that plain tensors made inside the forwards
  (rotary tables, masks) count as replicated; B3 and B4 run on each rank's
  local shards.  The train step returns parameters and optimizer state at
  their shardings and its metrics replicated (the reference's
  ``out_shardings=(p_sh, o_sh, rep)``).  The mesh is a real world of ranks
  (:func:`repro_torch.launch.mesh.device_mesh`), or the dry run's ``fake``
  one (:mod:`repro_torch.launch.dryrun`: one rank traced, nothing
  executed).  An :class:`AbstractMesh` with an axis larger than 1 raises
  ``NotImplementedError``: it has no devices to execute on.
"""

from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from .. import optim, trace_hooks
from ..configs.base import TrainConfig
from ..parallel.sharding import (AbstractMesh, NamedSharding, PartitionSpec,
                                 abstract_mesh_error, shard_tree, sharding_for, tree_shardings)

__all__ = ["make_optimizer", "make_train_fn", "named_leaves", "value_and_grad",
           "param_shardings", "batch_shardings", "cache_shardings", "opt_shardings",
           "make_train_step", "make_prefill_step", "make_decode_step"]


def make_optimizer(tcfg: TrainConfig) -> optim.Optimizer:
    """AdamW with the warmup-cosine schedule of ``tcfg``."""
    return optim.adamw(
        lr=optim.warmup_cosine(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps),
        weight_decay=tcfg.weight_decay,
        master_fp32=tcfg.master_fp32,
    )


def named_leaves(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(slash-joined name, leaf) of a tree of nested dicts, keys sorted at
    each level (the checkpoints' leaf order)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += named_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]
    return out


def _unflatten(pairs) -> dict:
    out: dict = {}
    for name, v in pairs:
        *parents, leaf = name.split("/")
        d = out
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def value_and_grad(loss_fn, params: dict, batch: dict):
    """(loss, grads) of ``loss_fn(params, batch)``: the loss detached, the
    gradients a tree like ``params``, each leaf in its parameter's dtype
    (zeros where the loss does not reach it)."""
    names, leaves = zip(*named_leaves(params))
    live = [p.detach().requires_grad_(True) for p in leaves]
    with record_function("lm.forward"):
        loss = loss_fn(_unflatten(zip(names, live)), batch)
    with record_function("lm.backward"):
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
    return loss.detach(), _unflatten(zip(names, grads))


def _microbatch(v, i: int, m: int):
    """Slice ``i`` of ``m`` along the batch axis: rows ``i * B/m`` onward,
    as the reference's reshape to (m, B/m, ...) takes them (an MoE's
    dispatch depends on which tokens share a microbatch).  A ``DTensor``
    sharded along the batch is gathered along it, sliced, and split again at
    its placements, or, where the microbatch's rows do not split that many
    ways, kept whole on every rank of those axes."""
    size = v.shape[0] // m
    if hasattr(v, "device_mesh") and any(getattr(p, "dim", None) == 0 for p in v.placements):
        from torch.distributed.tensor import Replicate
        mesh, pl = v.device_mesh, tuple(v.placements)
        whole = tuple(Replicate() if getattr(p, "dim", None) == 0 else p for p in pl)
        mb = v.redistribute(mesh, whole)[i * size: (i + 1) * size]
        ways = math.prod(n for n, p in zip(mesh.shape, pl) if getattr(p, "dim", None) == 0)
        return mb.redistribute(mesh, pl) if size % ways == 0 else mb
    return v[i * size: (i + 1) * size]


def make_train_fn(model, tcfg: TrainConfig, optimizer: optim.Optimizer):
    """The step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` of ``model`` (a :class:`~repro_torch.models.model.Model`)."""
    m = tcfg.microbatches

    def train_step(params, opt_state, batch):
        if m > 1:
            acc = optim.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            losses = []
            for i in trace_hooks.loop("microbatches", m):
                mb = {k: _microbatch(v, i, m) for k, v in batch.items()}
                loss, grads = value_and_grad(model.loss, params, mb)
                with record_function("lm.backward"):
                    optim.tree_map(lambda a, g: a.add_(g.float()), acc, grads)
                losses.append(loss)
                del grads
            grads = optim.tree_map(lambda g: g / m, acc)
            loss = torch.stack(losses).mean()
        else:
            loss, grads = value_and_grad(model.loss, params, batch)
        with record_function("lm.optimizer"):
            grads, gnorm = optim.clip_by_global_norm(grads, tcfg.max_grad_norm)
            params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, "step": opt_state.step}

    return train_step


def _meta_model(model):
    from ..models.model import Model
    return Model(model.cfg, torch.device("meta"))


def _executable(mesh) -> None:
    """Raise where ``mesh`` is abstract with an axis larger than 1."""
    err = abstract_mesh_error(mesh)
    if err is not None:
        raise err


def _on_mesh(step, mesh, out_shardings=None):
    """``step`` run under ``implicit_replication`` on a ``DeviceMesh``, its
    outputs moved to ``out_shardings``, a function of the step's arguments
    returning a tree of shardings (or None, left where they are) of the
    outputs' structure; on an abstract mesh ``step`` itself."""
    if isinstance(mesh, AbstractMesh):
        return step

    def run(*args, **kwargs):
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            out = step(*args, **kwargs)
            return out if out_shardings is None else _placed(out, out_shardings(*args))
    return run


def _placed(tree, shardings):
    """``tree``'s tensor leaves at ``shardings`` (a tree of the same
    structure; an ``OptState`` or a tuple is walked too): a ``DTensor``
    redistributed, a plain tensor (the same on every rank, as the
    optimizer's fresh step count) kept as each rank's shard of it, except on
    a one-device mesh (where the step is the single-device one)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_placed(t, s) for t, s in zip(tree, shardings))
    if isinstance(tree, optim.OptState):
        return optim.OptState.from_tree(_placed(tree.tree(), shardings.tree()))
    if isinstance(tree, dict):
        return {k: _placed(v, shardings[k]) for k, v in tree.items()}
    if tree is None or (not hasattr(tree, "device_mesh") and shardings.mesh.size() == 1):
        return tree
    return shard_tree(tree, shardings)


def param_shardings(model, mesh) -> dict:
    return tree_shardings(model.param_axes(), _meta_model(model).init_params(), mesh)


def batch_shardings(specs: dict, axes: dict, mesh) -> dict:
    """``specs`` (records, or tensors) and their logical ``axes`` ->
    shardings, as :meth:`~repro_torch.models.model.Model.input_records`
    gives them."""
    return tree_shardings(axes, specs, mesh)


def cache_shardings(model, mesh, batch: int, max_len: int) -> dict:
    return tree_shardings(model.cache_axes(), _meta_model(model).init_cache(batch, max_len), mesh)


def opt_shardings(optimizer: optim.Optimizer, model, mesh) -> optim.OptState:
    """The optimizer state's shardings: each moment (and master copy) its
    parameter's, the step replicated."""
    p_sh = param_shardings(model, mesh)
    state = optimizer.init(_meta_model(model).init_params())

    def mirror(shapes):
        return None if shapes is None else optim.tree_map(lambda _, sh: sh, shapes, p_sh)

    return optim.OptState(step=NamedSharding(mesh, PartitionSpec()), mu=mirror(state.mu),
                          nu=mirror(state.nu), master=mirror(state.master))


def make_train_step(model, mesh, tcfg: TrainConfig, specs: dict, axes: dict):
    """(step, (param, optimizer-state, batch shardings), optimizer).  The
    step is :func:`make_train_fn`'s; it returns parameters and optimizer
    state at their shardings and the metrics replicated."""
    _executable(mesh)
    optimizer = make_optimizer(tcfg)
    p_sh, o_sh = param_shardings(model, mesh), opt_shardings(optimizer, model, mesh)
    rep = NamedSharding(mesh, PartitionSpec())
    step = _on_mesh(make_train_fn(model, tcfg, optimizer), mesh, lambda p, o, b: (
        p_sh, o_sh, {k: rep for k in ("loss", "grad_norm", "step")}))
    return step, (p_sh, o_sh, batch_shardings(specs, axes, mesh)), optimizer


def make_prefill_step(model, mesh, specs: dict, axes: dict):
    """(``prefill(params, batch, max_len=None)``, (param shardings, batch
    shardings)).  The cache (``max_len`` long, default the prompt's) comes
    back at the decode step's cache shardings."""
    _executable(mesh)

    def prefill(params, batch, max_len=None):
        return model.prefill(params, batch, max_len=max_len)

    return _on_mesh(prefill, mesh), (param_shardings(model, mesh),
                                     batch_shardings(specs, axes, mesh))


def make_decode_step(model, mesh, batch: int, max_len: int):
    """(``decode(params, token, cache, kv_len)``, (param, token and cache
    shardings)).  The step writes into ``cache``, as ``Model.decode_step``
    does."""
    _executable(mesh)

    def decode(params, token, cache, kv_len):
        return model.decode_step(params, token, cache, kv_len)

    tok_sh = sharding_for(("batch", None), (batch, 1), mesh)
    return _on_mesh(decode, mesh), (param_shardings(model, mesh), tok_sh,
                                    cache_shardings(model, mesh, batch, max_len))
