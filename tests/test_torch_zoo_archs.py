"""The seven archs ported last (MLA, MoE, the VLM front end, the dense GQA
configs) served by the port against the JAX model, and the registry's
configs and analytics against the reference's.

Each arch's SMOKE config with the reference's own ``init_params`` weights
carried across by ``params_from_numpy``; the reference runs its Pallas
kernels in interpret mode (``tests/_torch_zoo.pair``).  A prefill of
B = 2 x 12 tokens (llava: 8 patch embeddings before them) then three
greedy decode steps, both models fed the reference's tokens:

* float32: logits within atol = rtol = 1e-4 (float32 sums in another order;
  measured at most 2.9e-6), greedy tokens equal;
* bfloat16: logits within atol = 0.12, rtol = 2e-2, the tolerances of
  ``tests/test_torch_lm.py`` (the frameworks round to bf16 at other places;
  measured at most 0.042).  One exception, stated: an MoE router fed two
  bf16 hidden states that differ by a rounding can pick another expert when
  the k-th and (k+1)-th gates are within that rounding, and the logits then
  differ by more (kimi-k2 SMOKE, decode step 1: 0.195, with a gate margin of
  6.6e-4 in the port's run).  A bf16 step of an MoE arch may exceed the
  tolerance only if the port's smallest top-k gate margin in that step is
  below 2^-9 (about one bf16 rounding of a gate near 0.5); the float32 case
  and ``tests/test_torch_moe.py`` hold the arithmetic exactly;
* the prefill cache after ``pad_cache_to`` — MLA's latents ``ckv``/``krope``,
  GQA's ``k``/``v`` — within the same tolerances.

The VLM: ``lm_loss`` with patches (text region only) against the
reference's, and ``input_specs`` beside ``_input_specs``.  The registry:
``all_configs()`` field by field, ``count_params``/``active_params`` of the
ten full configs on the meta device as integers, ``analytic_flops`` at
every shape.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_zoo import batch, drive, f32, pair

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import all_configs as jax_all_configs
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import lm as jax_lm
from repro.models import model as jax_model
from repro_torch.configs import ARCH_IDS, SHAPES, all_configs, get_config, get_smoke_config
from repro_torch.kernels import build
from repro_torch.models import lm, mlp
from repro_torch.models.model import active_params, analytic_flops, build_model, count_params

torch.set_num_threads(1)

NEW_ARCHS = ("qwen3-32b", "qwen3-14b", "minicpm3-4b", "internlm2-1.8b", "kimi-k2-1t-a32b",
             "qwen3-moe-235b-a22b", "llava-next-mistral-7b")
STEPS = 3
TOL = {"float32": {"atol": 1e-4, "rtol": 1e-4}, "bfloat16": {"atol": 0.12, "rtol": 2e-2}}
NEAR_TIE = 2.0 ** -9


def _inputs(cfg, seed=0):
    out = batch(cfg, 2, 12, seed)
    if cfg.family == "vlm":
        rng = np.random.default_rng(seed + 100)
        out["patches"] = rng.standard_normal((2, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


class _Margins:
    """The smallest k-th/(k+1)-th gate margin of each MoE route the port
    takes, in call order."""

    def __init__(self, monkeypatch):
        self.values = []
        real = mlp.moe_route

        def spy(p, cfg, xf):
            gates, top_p, top_e = real(p, cfg, xf)
            srt = torch.topk(gates, cfg.moe.top_k + 1, dim=-1).values
            self.values.append(float((srt[:, -2] - srt[:, -1]).min()))
            return gates, top_p, top_e
        monkeypatch.setattr(mlp, "moe_route", spy)


def _seq_leaves(tree, path=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _seq_leaves(val, f"{path}/{key}")
        elif key in ("k", "v", "ckv", "krope"):
            yield f"{path}/{key}", val


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype, monkeypatch):
    jm, jparams, model, params = pair(arch, dtype)
    cfg = model.cfg
    margins = _Margins(monkeypatch)
    inputs = _inputs(cfg)
    before = dict(build.LAUNCHES)
    # prefill, then decode at kv_len = (patches +) prompt tokens
    steps, _, _ = drive(jm, jparams, model, params, inputs, STEPS)
    assert build.LAUNCHES == before          # the CPU runs the plain versions
    assert params["blocks"]["u0"]["attn"].keys() == jparams["blocks"]["u0"]["attn"].keys()
    assert params["blocks"]["u0"]["mlp"].keys() == jparams["blocks"]["u0"]["mlp"].keys()
    per_step = cfg.pattern().count("a") if cfg.moe is not None else 0
    assert len(margins.values) == per_step * (STEPS + 1)
    for t, (got, want) in enumerate(steps):
        assert got.shape == (2, 1, cfg.vocab_size)
        got, want = f32(got), f32(want)
        err = np.abs(got - want)
        if not (err > TOL[dtype]["atol"] + TOL[dtype]["rtol"] * np.abs(want)).any():
            if dtype == "float32":
                assert np.array_equal(got.argmax(-1), want.argmax(-1)), f"step {t}"
            continue
        margin = min(margins.values[t * per_step: (t + 1) * per_step], default=1.0)
        assert dtype == "bfloat16" and margin < NEAR_TIE, (
            f"step {t}: max |err| {err.max():.3e}, the port's smallest gate margin {margin:.3e}")

    # the prefill cache, padded afterwards, against the reference's
    jin = {k: jnp.asarray(v, getattr(jnp, dtype) if v.dtype == np.float32 else None)
           for k, v in inputs.items()}
    tin = {k: torch.from_numpy(v).to(getattr(torch, dtype)) if v.dtype == np.float32
           else torch.from_numpy(v) for k, v in inputs.items()}
    s = inputs["tokens"].shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
    _, jcache = jax.jit(jm.prefill)(jparams, jin)
    jcache = jax_lm.pad_cache_to(jcache, s + STEPS)
    _, cache = model.prefill(params, tin)
    cache = lm.pad_cache_to(cache, s + STEPS)
    want = dict(_seq_leaves(jax.tree.map(np.asarray, jcache)))
    got = dict(_seq_leaves(cache))
    assert set(got) == set(want) and got
    want_keys = {"ckv", "krope"} if cfg.attention == "mla" else {"k", "v"}
    assert {name.rsplit("/", 1)[1] for name in got} == want_keys
    for name, leaf in got.items():
        assert leaf.shape[2] == s + STEPS, name          # (layers, B, S, ...)
        np.testing.assert_allclose(f32(leaf), f32(want[name]), **TOL[dtype], err_msg=name)


def test_vlm_loss_scores_the_text_region_like_jax():
    jm, jparams, model, params = pair("llava-next-mistral-7b", "float32")
    inputs = _inputs(model.cfg, seed=3)
    inputs["loss_mask"] = (np.random.default_rng(4).random((2, 12)) < 0.7).astype(np.float32)
    want = float(jax.jit(jm.loss)(jparams, {k: jnp.asarray(v) for k, v in inputs.items()}))
    got = float(model.loss(params, {k: torch.from_numpy(v) for k, v in inputs.items()}))
    assert got == pytest.approx(want, rel=1e-5)
    # the patches enter the loss only through the text positions' attention
    moved = dict(inputs, patches=inputs["patches"] * 2.0)
    assert float(model.loss(params, {k: torch.from_numpy(v) for k, v in moved.items()})) != got


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_vlm_input_specs_match_the_reference(shape):
    cfg = get_config("llava-next-mistral-7b")
    specs = build_model(cfg, device="meta").input_specs(SHAPES[shape])
    jspecs, _ = jax_model._input_specs(cfg, JAX_SHAPES[shape])
    assert set(specs) <= set(jspecs)
    for name, spec in specs.items():
        assert tuple(spec.shape) == jspecs[name].shape, name
        assert str(spec.dtype).split(".")[-1] == str(jspecs[name].dtype), name


def test_all_configs_equal_the_reference_field_by_field():
    ours, ref = all_configs(), jax_all_configs()
    assert tuple(ours) == tuple(ref) == ARCH_IDS
    for arch in ARCH_IDS:
        assert dataclasses.asdict(ours[arch]) == dataclasses.asdict(ref[arch]), arch
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(jax_get_smoke_config(arch)), arch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_flops_equal_the_reference(arch):
    cfg = get_config(arch)
    jcfg = jax_all_configs()[arch]
    n = count_params(build_model(cfg, device="meta"))
    assert n == jax_model.count_params(jax_model.build_model(jcfg))
    assert active_params(cfg) == jax_model.active_params(jcfg)
    if cfg.moe is None:
        assert active_params(cfg) == n
    for name, shape in SHAPES.items():
        assert analytic_flops(cfg, shape) == jax_model.analytic_flops(jcfg, JAX_SHAPES[name]), name
