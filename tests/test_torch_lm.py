"""The port's zamba2 serving path (prefill + decode) against the JAX model.

zamba2-7b SMOKE (6 layers "mmmmmA", d_model 64) with the reference's own
``init_lm`` weights carried across by ``params_from_numpy``; the reference
is ``build_model(cfg, remat=False, attn_impl="interpret",
ssd_impl="interpret")`` — its Pallas kernels in interpret mode.  One prefill
then 3 decode steps, both models fed the reference's greedy tokens:

* float32: logits within atol = rtol = 1e-4 (float32 sums in another order
  through every layer; measured about 3e-6), greedy tokens equal;
* a depth-9 variant (one unit plus the ``mmm`` tail) and a 16-head variant
  (the 3-D attention layouts), both float32 as above;
* bfloat16: logits and K/V cache within atol = 0.12, rtol = 2e-2 — the two
  frameworks round to bfloat16 at other places in every matmul, norm and
  activation (a step of 2^-7 relative; measured at most 0.078 at logits of
  magnitude 3, 0.076 in the cache), and the float32 SSM state within
  atol = 2e-3, rtol = 2e-2 (measured 9.5e-4).  This case guards the bf16
  casts; the float32 cases are the ones that catch a wrong model.

Also: the full zamba2-7b parameter count on the meta device, the registry
(the reference's ten archs, in its order), and the entry points' device
rule.  The ``cuda`` test runs only on a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as jax_arch_ids
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models.model import build_model as jax_build_model
from repro.models.model import count_params as jax_count_params
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import build
from repro_torch.models.lm import pad_cache_to, params_from_numpy
from repro_torch.models.model import build_model, count_params

torch.set_num_threads(1)

STEPS = 3


def _pair(dtype="float32", **kw):
    jcfg = jax_get_smoke_config("zamba2-7b").scaled(dtype=dtype, **kw)
    cfg = get_smoke_config("zamba2-7b").scaled(dtype=dtype, **kw)
    jm = jax_build_model(jcfg, remat=False, attn_impl="interpret", ssd_impl="interpret")
    jparams = jm.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jm, jparams, build_model(cfg, device="cpu"), params


F32_TOL = {"atol": 1e-4, "rtol": 1e-4}


@pytest.mark.parametrize("dtype,kw,tol,state_tol", [
    ("float32", {}, F32_TOL, F32_TOL),
    ("float32", {"n_layers": 9}, F32_TOL, F32_TOL),                       # unit + "mmm" tail
    ("float32", {"n_heads": 16, "n_kv_heads": 16}, F32_TOL, F32_TOL),     # 3-D attention layouts
    ("bfloat16", {}, {"atol": 0.12, "rtol": 2e-2}, {"atol": 2e-3, "rtol": 2e-2}),
], ids=["f32", "depth9", "heads16", "bf16"])
def test_prefill_and_decode_match_jax(dtype, kw, tol, state_tol):
    jm, jparams, model, params = _pair(dtype, **kw)
    rng = np.random.default_rng(0)
    b, s = 2, 12                       # 12: not a multiple of the SSD chunk (8)
    tokens = rng.integers(0, model.cfg.vocab_size, (b, s)).astype(np.int32)
    jlog, jcache = jax.jit(jm.prefill, static_argnames="max_len")(
        jparams, {"tokens": jnp.asarray(tokens)}, max_len=s + STEPS)
    before = dict(build.LAUNCHES)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens).long()},
                                  max_len=s + STEPS)
    jdecode = jax.jit(jm.decode_step)
    for t in range(STEPS + 1):
        assert logits.shape == (b, 1, model.cfg.vocab_size)
        np.testing.assert_allclose(logits.float().numpy(), np.asarray(jlog, np.float32),
                                   **tol, err_msg=f"step {t}")
        jtok = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
        if dtype == "float32":
            assert np.array_equal(logits.float().argmax(-1).numpy(), np.asarray(jtok))
        if t == STEPS:
            break
        jlog, jcache = jdecode(jparams, jtok, jcache, jnp.int32(s + t))
        logits, cache = model.decode_step(params, torch.from_numpy(np.array(jtok)).long(),
                                          cache, s + t)
    assert build.LAUNCHES == before          # the CPU runs the plain versions
    # the caches agree too: attention K/V of every A site, the SSM states
    np.testing.assert_allclose(cache["blocks"]["u5"]["k"].float().numpy(),
                               np.asarray(jcache["blocks"]["u5"]["k"], np.float32), **tol)
    np.testing.assert_allclose(cache["blocks"]["u0"]["state"].numpy(),
                               np.asarray(jcache["blocks"]["u0"]["state"]), **state_tol)


def test_prefill_cache_padding_matches_pad_cache_to():
    _, _, model, params = _pair()
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 9)))
    l1, c1 = model.prefill(params, {"tokens": tokens}, max_len=16)
    l2, c2 = model.prefill(params, {"tokens": tokens})
    c2 = pad_cache_to(c2, 16)
    torch.testing.assert_close(l1, l2, atol=0, rtol=0)
    assert c1["blocks"]["u5"]["k"].shape == c2["blocks"]["u5"]["k"].shape == (1, 1, 16, 4, 16)
    for unit in c1["blocks"]:
        for key in c1["blocks"][unit]:
            torch.testing.assert_close(c1["blocks"][unit][key], c2["blocks"][unit][key],
                                       atol=0, rtol=0)


def test_full_config_param_count_on_meta():
    model = build_model(get_config("zamba2-7b"), device="meta")
    n = count_params(model)
    assert n == 5_768_654_656
    assert n == jax_count_params(jax_build_model(jax_get_config("zamba2-7b")))


def test_params_from_numpy_keeps_dtypes_and_checks_shapes():
    _, jparams, model, params = _pair("bfloat16")
    assert params["blocks"]["u0"]["mamba"]["in_proj"].dtype == torch.bfloat16
    assert params["blocks"]["u0"]["mamba"]["a_log"].dtype == torch.float32
    assert params["blocks"]["u0"]["mamba"]["in_proj"].shape[0] == 1    # n_full stack
    tree = jax.tree.map(np.asarray, jparams)
    tree["final_norm"] = tree["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(model.cfg, tree, "cpu")


@pytest.mark.parametrize("heads", [4, 16])
def test_param_layouts_are_the_reference_defaults(heads):
    """3-D attention projections exactly when n_heads % 16 == 0, and the
    fused (d, 2, f) gate+up MLP, leaf for leaf as the JAX model draws them."""
    cfg = get_smoke_config("zamba2-7b").scaled(n_heads=heads, n_kv_heads=heads)
    shared = build_model(cfg, device="meta").init_params(0)["shared_attn"]
    jcfg = jax_get_smoke_config("zamba2-7b").scaled(n_heads=heads, n_kv_heads=heads)
    jshared = jax.eval_shape(jax_build_model(jcfg).init_params, jax.random.PRNGKey(0))["shared_attn"]
    d, dh = cfg.d_model, cfg.resolved_head_dim
    want_wq = (d, heads, dh) if heads % 16 == 0 else (d, heads * dh)
    assert tuple(shared["attn"]["wq"].shape) == want_wq
    assert tuple(shared["mlp"]["w13"].shape) == (d, 2, cfg.d_ff)
    for part in ("attn", "mlp"):
        assert {k: tuple(v.shape) for k, v in shared[part].items()} == \
            {k: tuple(v.shape) for k, v in jshared[part].items()}


def test_registry_lists_the_reference_archs():
    assert ARCH_IDS == jax_arch_ids
    assert dataclasses.asdict(get_config("qwen3-32b")) == \
        dataclasses.asdict(jax_get_config("qwen3-32b"))
    with pytest.raises(KeyError, match="unknown"):
        get_config("no-such-arch")


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_smoke_config("zamba2-7b"))
    assert build_model(get_smoke_config("zamba2-7b"), device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------- #
# on the card only
# ---------------------------------------------------------------------- #
@pytest.mark.cuda
def test_kernel_path_matches_cpu_plain_path_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    cfg = get_smoke_config("zamba2-7b").scaled(dtype="float32", n_layers=9)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init_params(0)
    gpu = build_model(cfg)
    gparams = params_from_numpy(cfg, jax.tree.map(lambda t: t.numpy(), params), "cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 100)))
    before = dict(build.LAUNCHES)
    want, _ = cpu.prefill(params, {"tokens": tokens})
    got, _ = gpu.prefill(gparams, {"tokens": tokens})
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    assert build.LAUNCHES["ssd_scan"] == before["ssd_scan"] + 8
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
