"""The port's whisper (``repro_torch.models.whisper``) against the JAX model.

whisper-tiny SMOKE (2 encoder + 2 decoder layers, d_model 64, 32 frames)
with the reference's own weights carried across by ``params_from_numpy``;
the reference runs its flash kernel in interpret mode.  One prefill of
B = 2, S = 12, then 4 greedy decode steps, both models fed the reference's
tokens:

* float32: logits within atol = rtol = 1e-4 (float32 sums in another order;
  measured about 5e-7), greedy tokens equal; the self-attention and cross
  K/V caches within the same tolerance;
* bfloat16: logits within atol = 0.12, rtol = 2e-2 (the two frameworks
  round to bfloat16 at other places, as in ``tests/test_torch_lm.py``).

Also: the full whisper-tiny parameter count on the meta device, the model's
input specs, and a ``cuda`` test (the kernel path against the CPU plain
path at whisper-tiny's head width, D = 64, non-causal encoder and cross
attention) that runs only on a card.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_zoo import batch, drive, f32, pair
from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.models.model import count_params as jax_count_params
from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
from repro_torch.kernels import build
from repro_torch.models.model import build_model, count_params

torch.set_num_threads(1)

ARCH = "whisper-tiny"
STEPS = 4


@pytest.mark.parametrize("dtype,tol", [
    ("float32", {"atol": 1e-4, "rtol": 1e-4}),
    ("bfloat16", {"atol": 0.12, "rtol": 2e-2}),
], ids=["f32", "bf16"])
def test_prefill_and_decode_match_jax(dtype, tol):
    jm, jparams, model, params = pair(ARCH, dtype)
    before = dict(build.LAUNCHES)
    steps, cache, jcache = drive(jm, jparams, model, params, batch(model.cfg, 2, 12), STEPS)
    assert build.LAUNCHES == before          # the CPU runs the plain versions
    for t, (got, want) in enumerate(steps):
        assert got.shape == (2, 1, model.cfg.vocab_size)
        np.testing.assert_allclose(f32(got), f32(want), **tol, err_msg=f"step {t}")
        if dtype == "float32":
            assert np.array_equal(f32(got).argmax(-1), f32(want).argmax(-1))
    if dtype == "float32":
        for key in ("cross_k", "cross_v"):
            np.testing.assert_allclose(f32(cache[key]), f32(jcache[key]), **tol)
        np.testing.assert_allclose(f32(cache["self"]["k"]), f32(jcache["self"]["k"]), **tol)


def test_cache_layout_and_input_specs():
    _, _, model, params = pair(ARCH)
    cfg = model.cfg
    cache = model.init_cache(2, 20)
    dh = cfg.resolved_head_dim
    assert cache["self"]["k"].shape == (cfg.n_layers, 2, 20, cfg.n_kv_heads, dh)
    assert cache["cross_k"].shape == (cfg.n_layers, 2, cfg.encoder_seq, cfg.n_kv_heads, dh)
    specs = model.input_specs(ShapeConfig("t", 16, 2, "prefill"))
    assert specs["tokens"].shape == (2, 16) and specs["tokens"].is_meta
    assert specs["audio_embed"].shape == (2, cfg.encoder_seq, cfg.d_model)
    assert set(model.input_specs(ShapeConfig("t", 16, 2, "decode"))) == {"token"}


def test_full_config_param_count_on_meta():
    n = count_params(build_model(get_config(ARCH), device="meta"))
    assert n == jax_count_params(jax_build_model(jax_get_config(ARCH)))
    params = build_model(get_config(ARCH), device="meta").init_params()

    def nbytes(tree):
        return sum(nbytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
                   for v in tree.values())
    assert nbytes(params) == 83_485_440          # BENCH_ingest.json's param_bytes_total


def test_params_from_numpy_checks_the_tree():
    from repro_torch.models.lm import params_from_numpy
    _, jparams, model, _ = pair(ARCH)
    tree = jax.tree.map(np.asarray, jparams)
    del tree["enc_pos"]
    with pytest.raises(ValueError, match="enc_pos"):
        params_from_numpy(model.cfg, tree, "cpu")


# ---------------------------------------------------------------------- #
# on the card only
# ---------------------------------------------------------------------- #
@pytest.mark.cuda
def test_kernel_path_matches_cpu_plain_path_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    cfg = get_smoke_config(ARCH).scaled(dtype="float32", d_model=384, n_heads=6, n_kv_heads=6,
                                        d_ff=256, encoder_seq=300)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init_params(seed=0)
    inputs = {k: torch.from_numpy(v) for k, v in batch(cfg, 2, 40).items()}
    want, _ = cpu.prefill(params, inputs)
    card = build_model(cfg, device="cuda")
    before = build.LAUNCHES["flash_fwd"]
    got, _ = card.prefill({k: _to(v) for k, v in params.items()}, inputs)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd"] == before + cfg.encoder_layers + 2 * cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def _to(tree):
    return {k: _to(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.cuda()
