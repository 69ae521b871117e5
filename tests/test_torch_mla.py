"""The port's MLA (``models.attention.mla_forward``) against the
reference's, and on the card its kernel path against its plain path.

minicpm3-4b's SMOKE dims (4 heads, q_lora 32, kv_lora 16, nope = rope = 8,
v 8) in float32, the reference's ``init_mla`` weights carried across as
numpy, the reference's flash op in interpret mode:

* ``train`` and ``prefill`` (the materialized path through the flash op at
  D = nope + rope, Dv = v): the output within atol = rtol = 1e-5 (float32
  sums in another order; measured 8.3e-7), the prefill's latent cache
  ``ckv``/``krope`` too;
* ``decode`` (the absorbed path, plain float32) of two steps at kv_len = 11
  and 12 against a cache of 16 after an 11-token prefill: output and the
  cache the step wrote, at the same tolerance.

The ``cuda`` test runs minicpm3's full-width MLA unit (d_model 2560, 40
heads, D = 96, Dv = 64) in float32 through B3's CUDA-core template and
through the plain version, at the path's layout, within 1e-4 x max(1,
|out|) (the served models' float32 units' tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import attention as jax_attn
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import build
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash.ref import reference_attention
from repro_torch.models import attention
from repro_torch.models.common import Init

torch.set_num_threads(1)

ARCH = "minicpm3-4b"
TOL = {"atol": 1e-5, "rtol": 1e-5}


def _pair():
    jcfg = jax_get_smoke_config(ARCH).scaled(dtype="float32")
    cfg = get_smoke_config(ARCH).scaled(dtype="float32")
    jp = jax_attn.init_mla(jax.random.PRNGKey(0), jcfg)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    assert set(p) == {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b", "wv_b", "wo"}
    return jcfg, cfg, jp, p


def _x(cfg, b, s, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_materialized_path_matches_jax(mode):
    jcfg, cfg, jp, p = _pair()
    x = _x(cfg, 2, 11)
    want, jcache = jax_attn.mla_forward(jp, jcfg, jnp.asarray(x), jnp.arange(11), mode=mode,
                                        attn_impl="interpret")
    got, cache = attention.mla_forward(p, cfg, torch.from_numpy(x), torch.arange(11), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if mode == "train":
        assert cache is None and jcache is None
        return
    assert set(cache) == {"ckv", "krope"}
    for key in cache:
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), **TOL, err_msg=key)


def test_absorbed_decode_matches_jax():
    jcfg, cfg, jp, p = _pair()
    x = _x(cfg, 2, 11)
    _, pre = attention.mla_forward(p, cfg, torch.from_numpy(x), torch.arange(11), mode="prefill")
    cache = attention.init_mla_cache(Init(torch.device("cpu")), cfg, 2, 16)
    for key in cache:
        cache[key][:, :11] = pre[key]
    jcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    for t, kv_len in enumerate((11, 12)):
        xt = _x(cfg, 2, 1, seed=10 + t)
        want, jcache = jax_attn.mla_forward(jp, jcfg, jnp.asarray(xt), kv_len + jnp.arange(1),
                                            mode="decode", cache=jcache, kv_len=kv_len)
        got, cache = attention.mla_forward(p, cfg, torch.from_numpy(xt),
                                           kv_len + torch.arange(1), mode="decode",
                                           cache=cache, kv_len=kv_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"step {t}")
        for key in cache:
            np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), **TOL,
                                       err_msg=f"step {t} {key}")
    assert not cache["ckv"][:, 13:].any()


@pytest.mark.cuda
def test_full_width_mla_unit_kernel_path_matches_plain_on_cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    cfg = get_config(ARCH).scaled(dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = attention.init_mla(Init(torch.device("cuda"), gen), cfg)
    x = torch.randn((2, 1024, cfg.d_model), generator=gen, device="cuda")
    pos = torch.arange(1024, device="cuda")
    before = build.LAUNCHES["flash_fwd"]
    got, _ = attention.mla_forward(p, cfg, x, pos, mode="prefill")
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd"] == before + 1
    monkeypatch.setattr(flash_ops, "flash_attention_cuda",
                        lambda q, k, v, *, causal, scale: reference_attention(
                            q, k, v, causal=causal, scale=scale))
    want, _ = attention.mla_forward(p, cfg, x, pos, mode="prefill")
    err = float((got - want).abs().max())
    assert err <= 1e-4 * max(1.0, float(want.abs().max())), err
