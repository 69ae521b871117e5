"""The port's optimizers, clipping and schedules against ``repro.optim``.

Same trees and gradients, made from a seed with numpy, through both
packages for several steps.  Tolerances: 1e-6 relative (float32, the same
operations in the same order per element; only ``pow`` and the norm's sum
may round differently), and a leaf whose gradient is zero on alternate
steps (None in the port, as a frozen-out parameter's ``.grad`` is) still
decays its moments and moves exactly as in the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim as toptim

torch.set_num_threads(1)

SHAPES = {"a": (4, 3), "b": (5,), "c": {"d": (2, 2), "e": (3,)}}
RTOL = 1e-6


def _tree(rng, shapes, scale=1.0):
    return {k: _tree(rng, v, scale) if isinstance(v, dict)
            else (scale * rng.standard_normal(v)).astype(np.float32) for k, v in shapes.items()}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _close(jtree, ttree, rtol=RTOL):
    jl = dict(_leaves(jax.tree.map(np.asarray, jtree)))
    tl = {k: v.numpy() for k, v in _leaves(ttree)}
    assert jl.keys() == tl.keys()
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=rtol, atol=rtol * np.abs(jl[k]).max(),
                                   err_msg=k)


def _run(jopt, topt, steps=6, zero_leaf=True):
    """``steps`` updates of both optimizers on one seeded tree; leaf
    ``b`` gets a zero gradient on odd steps (None in the port)."""
    rng = np.random.default_rng(0)
    params = _tree(rng, SHAPES)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(steps):
        g = _tree(rng, SHAPES, scale=0.1)
        jg, tg = jax.tree.map(jnp.asarray, g), _to_torch(g)
        if zero_leaf and step % 2:
            jg["b"] = jnp.zeros_like(jg["b"])
            tg["b"] = None
        jp, js = jopt.update(jg, js, jp)
        tp, ts = topt.update(tg, ts, tp)
        _close(jp, tp)
        assert int(js.step) == int(ts.step) == step + 1
    return js, ts


@pytest.mark.parametrize("kw", [dict(lr=1e-2), dict(lr=3e-4, weight_decay=0.1),
                                dict(lr=1e-2, master_fp32=True)],
                         ids=["plain", "decay", "master"])
def test_adamw_matches_reference(kw):
    js, ts = _run(joptim.adamw(**kw), toptim.adamw(**kw))
    _close(js.mu, ts.mu)
    _close(js.nu, ts.nu)
    assert (js.master is None) == (ts.master is None)


def test_adamw_moves_a_leaf_without_gradient():
    """A None gradient is a zero one: the leaf's moments decay and it keeps
    moving (``torch.optim.Adam`` would skip it)."""
    opt = toptim.adamw(lr=1e-2)
    p = {"w": torch.ones(3)}
    s = opt.init(p)
    p, s = opt.update({"w": torch.ones(3)}, s, p)
    mu1 = s.mu["w"].clone()
    p2, s = opt.update({"w": None}, s, p)
    assert torch.equal(s.mu["w"], 0.9 * mu1)
    assert not torch.equal(p2["w"], p["w"])


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    _run(joptim.sgd(lr=1e-2, momentum=momentum), toptim.sgd(lr=1e-2, momentum=momentum))


@pytest.mark.parametrize("max_norm", [0.1, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(np.random.default_rng(1), SHAPES)
    jc, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tc, tn = toptim.clip_by_global_norm(_to_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    np.testing.assert_allclose(float(toptim.global_norm(_to_torch(g))), float(jn), rtol=RTOL)
    _close(jc, tc)


@pytest.mark.parametrize("name", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match_reference(name):
    make = {"constant": lambda m: m.constant_schedule(3e-4),
            "cosine": lambda m: m.cosine_schedule(1e-3, 50),
            "warmup_cosine": lambda m: m.warmup_cosine(1e-3, 10, 50)}[name]
    jf, tf = make(joptim), make(toptim)
    for step in (0, 1, 5, 10, 11, 30, 50, 70):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        got = float(tf(torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=RTOL), step


def test_adamw_with_schedule_matches_reference():
    _run(joptim.adamw(lr=joptim.warmup_cosine(1e-2, 2, 6)),
         toptim.adamw(lr=toptim.warmup_cosine(1e-2, 2, 6)))
