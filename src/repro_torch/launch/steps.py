"""The LM zoo's train step (the reference's ``repro.launch.steps``, single
device).

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
and ``lm.optimizer`` (clip and update) split a profiled step.  The
reference's shardings belong to data and model parallelism, which the port
does not have.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from .. import optim
from ..configs.base import TrainConfig

__all__ = ["make_optimizer", "make_train_fn", "named_leaves", "value_and_grad"]


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


def make_train_fn(model, tcfg: TrainConfig, optimizer: optim.Optimizer):
    """The step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` of ``model`` (a :class:`~repro_torch.models.model.Model`)."""
    m = tcfg.microbatches

    def train_step(params, opt_state, batch):
        if m > 1:
            size = next(iter(batch.values())).shape[0] // m
            acc = optim.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), params)
            losses = []
            for i in range(m):
                mb = {k: v[i * size: (i + 1) * size] for k, v in batch.items()}
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
