"""The layout flags' forwards and the sharded step makers on the CPU.

* SMOKE archs built with ``fused_w13`` and ``head_sharded_layouts`` off (and
  internlm2-1.8b widened to 16 heads, so that the flag decides between the
  3-D and 2-D GQA layouts) match the reference's prefill and greedy decode
  under the same flags, the reference's weights carried across by
  ``params_from_numpy`` (whatever the port's flags), at the zoo's float32
  tolerance (atol = rtol = 1e-4; float32 sums in another order).
* On a one-device CPU mesh over a single gloo rank, ``make_prefill_step``,
  ``make_decode_step`` and ``make_train_step`` equal the single-device
  calls exactly, and every sharding they return is the resolver's on that
  mesh; on an abstract mesh with an axis larger than 1 (no devices) the step
  makers raise.  On the reference's
  256-chip mesh the shardings resolve without allocating the full config.
"""

from __future__ import annotations

import copy

import jax
import numpy as np
import pytest
import torch
from _torch_zoo import batch, drive, f32, pair

from repro.models import flags as jax_flags
from repro_torch import optim
from repro_torch.configs import ShapeConfig, TrainConfig, get_config, get_smoke_config
from repro_torch.launch import (batch_shardings, cache_shardings, make_decode_step,
                                make_optimizer, make_prefill_step, make_production_mesh,
                                make_train_fn, make_train_step, named_leaves, opt_shardings,
                                param_shardings, single_device_mesh, small_test_mesh)
from repro_torch.models import flags
from repro_torch.models.lm import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.parallel.sharding import NamedSharding, PartitionSpec, is_axes, resolve_axes

TOL = {"atol": 1e-4, "rtol": 1e-4}
UNFUSED = dict(fused_w13=False, head_sharded_layouts=False)
WIDE = dict(n_heads=16, n_kv_heads=4, head_dim=8)      # 16 heads: the flag decides


def _same_tree(a: dict, b: dict) -> bool:
    la, lb = named_leaves(a), named_leaves(b)
    return [n for n, _ in la] == [n for n, _ in lb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


@pytest.mark.parametrize("arch,setting,widen", [
    ("internlm2-1.8b", "unfused", True),
    ("internlm2-1.8b", "default", True),
    ("whisper-tiny", "unfused", False),
])
def test_flag_layouts_match_the_reference(arch, setting, widen):
    kw = UNFUSED if setting == "unfused" else {}
    with flags.flags(**kw), jax_flags.flags(**kw):
        jm, jparams, model, params = pair(arch, **(WIDE if widen else {}))
    names = {k.rsplit("/", 1)[-1] for k, _ in named_leaves(params)}
    assert ("w13" in names) == (setting == "default")
    if widen:
        wq = params["blocks"]["u0"]["attn"]["wq"]
        assert wq.ndim == (4 if setting == "default" else 3)
    inputs = batch(model.cfg, 2, 12)
    pairs, _, _ = drive(jm, jparams, model, params, inputs, steps=2)
    for t, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(f32(got), f32(want), **TOL, err_msg=f"{arch} step {t}")


def test_params_from_numpy_takes_either_layout():
    """A flag-False tree loads while the port's flags are at their defaults,
    and a tree that fits no layout raises naming the current one."""
    with flags.flags(**UNFUSED), jax_flags.flags(**UNFUSED):
        _, jparams, model, params = pair("internlm2-1.8b", **WIDE)
    cfg = model.cfg
    nested = jax.tree.map(np.asarray, jparams)
    assert flags.get("fused_w13") and flags.get("head_sharded_layouts")
    again = params_from_numpy(cfg, nested, "cpu")
    assert _same_tree(again, params)
    nested["blocks"]["u0"]["mlp"]["w1"] = nested["blocks"]["u0"]["mlp"]["w1"][..., :-1]
    # the error is the current (default, 3-D) layout's
    with pytest.raises(ValueError, match=r"wq: expected torch.float32 \(2, 64, 16, 8\)"):
        params_from_numpy(cfg, nested, "cpu")


@pytest.fixture
def cpu_mesh():
    """A one-rank CPU DeviceMesh; the process group it made is torn down
    after the test (other files in this worker expect none)."""
    import torch.distributed as dist
    had_group = dist.is_initialized()
    yield single_device_mesh("cpu")
    if not had_group and dist.is_initialized():
        dist.destroy_process_group()


def _resolved(axes_tree, shape_tree, mesh, sh_tree) -> None:
    for (path, ax), (_, shp), (_, sh) in zip(named_leaves(axes_tree), named_leaves(shape_tree),
                                             named_leaves(sh_tree)):
        assert is_axes(ax)
        assert sh == NamedSharding(mesh, resolve_axes(ax, tuple(shp.shape), mesh)), path


def _model(arch="internlm2-1.8b"):
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    model = build_model(cfg, device="cpu")
    return model, model.init_params(seed=0)


def test_prefill_and_decode_steps_equal_the_single_device_calls(cpu_mesh):
    mesh = cpu_mesh
    model, params = _model()
    b, s, steps = 2, 12, 3
    specs, axes = model.input_records(ShapeConfig("t", s, b, "prefill"))
    fn, (p_sh, b_sh) = make_prefill_step(model, mesh, specs, axes)
    _resolved(model.param_axes(), params, mesh, p_sh)
    _resolved(axes, specs, mesh, b_sh)
    assert b_sh["tokens"].spec == PartitionSpec("data", None)
    tokens = torch.from_numpy(batch(model.cfg, b, s)["tokens"])
    logits, cache = fn(params, {"tokens": tokens})
    want, want_cache = model.prefill(params, {"tokens": tokens})
    assert torch.equal(logits, want)
    assert _same_tree(cache, want_cache)

    max_len = s + steps
    dfn, (p_sh2, tok_sh, c_sh) = make_decode_step(model, mesh, b, max_len)
    assert p_sh2 == p_sh and tok_sh == NamedSharding(mesh, PartitionSpec("data", None))
    _resolved(model.cache_axes(), model.init_cache(b, max_len), mesh, c_sh)
    assert c_sh == cache_shardings(model, mesh, b, max_len)
    _, cache = model.prefill(params, {"tokens": tokens}, max_len=max_len)
    ref_cache = copy.deepcopy(cache)
    tok = logits.argmax(-1)
    for t in range(steps):
        got, cache = dfn(params, tok, cache, s + t)
        ref, ref_cache = model.decode_step(params, tok, ref_cache, s + t)
        assert torch.equal(got, ref), t
        tok = got.argmax(-1)
    assert _same_tree(cache, ref_cache)


def test_train_step_equals_the_single_device_step(cpu_mesh):
    mesh = cpu_mesh
    model, params = _model()
    tcfg = TrainConfig(microbatches=2, lr=1e-3, warmup_steps=1, total_steps=10)
    b, s = 4, 16
    specs, axes = model.input_records(ShapeConfig("t", s, b, "train"))
    fn, (p_sh, o_sh, b_sh), optimizer = make_train_step(model, mesh, tcfg, specs, axes)
    _resolved(model.param_axes(), params, mesh, p_sh)
    assert o_sh.step == NamedSharding(mesh, PartitionSpec())
    assert o_sh.mu == p_sh and o_sh.nu == p_sh and o_sh.master is None
    assert o_sh == opt_shardings(optimizer, model, mesh)
    assert b_sh == batch_shardings(specs, axes, mesh)
    data = {"tokens": torch.from_numpy(batch(model.cfg, b, s)["tokens"])}
    ref_opt = make_optimizer(tcfg)
    ref_fn = make_train_fn(model, tcfg, ref_opt)
    got_p, got_o, got_m = fn(params, optimizer.init(params), data)
    want_p, want_o, want_m = ref_fn(params, ref_opt.init(params), data)
    for key in ("loss", "grad_norm", "step"):
        assert torch.equal(got_m[key], want_m[key]), key
    for (path, a), (_, w) in zip(named_leaves(got_p), named_leaves(want_p)):
        assert torch.equal(a, w), path
    assert torch.equal(got_o.step, want_o.step)
    moved = [float((a - p).abs().max()) for (_, a), (_, p) in zip(named_leaves(got_p),
                                                                  named_leaves(params))]
    assert max(moved) > 0


def test_step_makers_raise_on_a_sharded_axis():
    """An abstract mesh has no devices: the step makers refuse to execute on
    one with an axis larger than 1 (a ``DeviceMesh`` of that shape over a
    world of ranks executes: ``tests/test_torch_sharded_exec.py``)."""
    model, _ = _model()
    mesh = small_test_mesh()                 # (2, 4) over (data, model)
    specs, axes = model.input_records(ShapeConfig("t", 8, 2, "prefill"))
    tcfg = TrainConfig()
    for build in (lambda: make_prefill_step(model, mesh, specs, axes),
                  lambda: make_decode_step(model, mesh, 2, 16),
                  lambda: make_train_step(model, mesh, tcfg, specs, axes)):
        with pytest.raises(NotImplementedError,
                           match="'data' has size 2 on an abstract mesh, which has no devices"):
            build()
    for build in (lambda: make_prefill_step(model, small_test_mesh(1, 4), specs, axes),
                  lambda: make_decode_step(model, small_test_mesh(1, 2), 2, 16)):
        with pytest.raises(NotImplementedError, match="'model' has size"):
            build()


def test_shardings_on_the_production_mesh_without_allocating():
    """qwen3-14b at full width on the reference's (16, 16) mesh: shapes from
    the meta device (its 40 heads keep the 2-D layout), FSDP over data."""
    cfg = get_config("qwen3-14b")
    model = build_model(cfg, device="meta")
    mesh = make_production_mesh()
    p_sh = param_shardings(model, mesh)
    attn = p_sh["blocks"]["u0"]["attn"]
    assert attn["wq"].spec == PartitionSpec(None, "data", "model")   # 2-D: 40 * 128 divides
    assert attn["q_norm"].spec == PartitionSpec(None, None)
    assert p_sh["embed"].spec == PartitionSpec("model", None)
    o_sh = opt_shardings(make_optimizer(TrainConfig(master_fp32=True)), model, mesh)
    assert o_sh.master == p_sh and o_sh.mu == p_sh
    c_sh = cache_shardings(model, mesh, 128, 32768)
    assert c_sh["blocks"]["u0"]["k"].spec == PartitionSpec(None, "data", "model", None, None)
    assert optim.tree_map(lambda s: isinstance(s, NamedSharding), p_sh)
