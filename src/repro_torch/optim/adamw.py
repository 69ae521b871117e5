"""Functional optimizers (AdamW, SGD) on trees of tensors.

The counterpart of the reference's ``repro.optim.adamw``, with its API shape
and its arithmetic: ``init(params)`` builds an :class:`OptState` of moment
trees mirroring ``params``, ``update(grads, state, params)`` returns the
new parameters and state.  Trees are nested dicts of float32 tensors with
the parameter tree's keys.

Not ``torch.optim.Adam(W)``: that places ``eps`` and the bias correction
differently, and it skips every parameter whose ``.grad`` is None.  The
reference updates every leaf every step — a leaf with a zero gradient still
decays its moments and can still move — so a None gradient here counts as
zeros.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = ["OptState", "Optimizer", "adamw", "sgd", "tree_map"]


def tree_map(f, tree, *rest):
    """``f`` over the leaves of nested dicts; ``rest`` trees share the
    keys of ``tree``, and a None there stands for a missing gradient."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(None if r is None else r.get(k) for r in rest))
                for k in tree}
    return f(tree, *rest)


@dataclasses.dataclass
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


@dataclasses.dataclass
class OptState:
    """``step`` is a () int32 tensor; ``mu``/``nu`` trees of float32
    moments (None where the optimizer keeps none); ``master`` float32
    master copies or None."""

    step: torch.Tensor
    mu: Any
    nu: Any
    master: Any = None

    def tree(self) -> dict:
        """The state under the reference's checkpoint leaf names: ``0`` the
        step, ``1`` mu, ``2`` nu, ``3`` master (a None is an empty
        subtree)."""
        return {"0": self.step, "1": self.mu, "2": self.nu, "3": self.master}

    @classmethod
    def from_tree(cls, tree: dict) -> "OptState":
        return cls(step=tree["0"], mu=tree.get("1"), nu=tree.get("2"), master=tree.get("3"))


def _lr_fn(lr):
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def _grad(g, p):
    return torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()


def adamw(lr: float | Callable = 1e-4, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, master_fp32: bool = False) -> Optimizer:
    """AdamW with decoupled weight decay; the bias corrections are
    ``1 - b ** step`` in float32 and the step is
    ``lr * (mhat / (sqrt(vhat) + eps) + wd * p)``, as in the reference."""
    lr_fn = _lr_fn(lr)

    def init(params):
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        master = tree_map(lambda p: p.detach().float().clone(), params) if master_fp32 else None
        dev = next(iter(_leaves(params))).device
        return OptState(step=torch.zeros((), dtype=torch.int32, device=dev), mu=zeros,
                        nu=tree_map(torch.clone, zeros), master=master)

    def update(grads, state: OptState, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        stepf = step.float()
        b1c = 1.0 - torch.tensor(b1, dtype=torch.float32, device=step.device) ** stepf
        b2c = 1.0 - torch.tensor(b2, dtype=torch.float32, device=step.device) ** stepf
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * _grad(g, m), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(_grad(g, v)), state.nu, grads)
        base = state.master if state.master is not None else params

        def upd(p, m, v):
            p = p.detach().float()
            return p - lr_t * ((m / b1c) / (torch.sqrt(v / b2c) + eps) + weight_decay * p)

        new_base = tree_map(upd, base, mu, nu)
        new_params = tree_map(lambda p, nb: nb.to(p.dtype), params, new_base)
        new_master = new_base if state.master is not None else None
        return new_params, OptState(step=step, mu=mu, nu=nu, master=new_master)

    return Optimizer(init=init, update=update)


def sgd(lr: float | Callable = 1e-2, momentum: float = 0.0) -> Optimizer:
    """Plain SGD, with heavy-ball momentum when ``momentum`` is non-zero."""
    lr_fn = _lr_fn(lr)

    def init(params):
        dev = next(iter(_leaves(params))).device
        mu = (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
              if momentum else None)
        return OptState(step=torch.zeros((), dtype=torch.int32, device=dev), mu=mu, nu=None)

    def update(grads, state: OptState, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + _grad(g, m), state.mu, grads)
            upd = mu
        else:
            mu, upd = None, tree_map(lambda p, g: _grad(g, p), params, grads)
        new_params = tree_map(lambda p, u: (p.detach().float() - lr_t * u).to(p.dtype),
                              params, upd)
        return new_params, OptState(step=step, mu=mu, nu=None)

    return Optimizer(init=init, update=update)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif tree is not None:
        yield tree
