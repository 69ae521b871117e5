"""``Model.loss`` and its gradients for MLA (minicpm3-4b), MoE
(qwen3-moe-235b-a22b, and kimi-k2-1t-a32b with its MLA), the VLM
(llava-next-mistral-7b, with patches), qk-norm GQA (qwen3-14b, qwen3-32b)
and plain GQA (internlm2-1.8b) against ``jax.value_and_grad`` of the
reference's loss.

SMOKE configs in float32, the reference built as in
``tests/test_torch_lm_train.py`` (``attn_impl="chunked"``: the flash custom
VJP, its CPU training route), its ``init_params`` weights carried across;
B = 2 x 12 tokens (llava: 8 patch embeddings before them).  The loss within
rtol = 1e-5 and every parameter leaf's gradient within atol = rtol = 1e-4 x
max(1, max|g|), the tolerances of ``tests/test_torch_lm_train.py`` (float32
sums in another order), and no leaf's gradient zero.  The MoE's gradient
reaches the router through the renormalized top-k gates and the experts
through the scatter and gather of the dispatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.launch import named_leaves, value_and_grad
from repro_torch.models.lm import params_from_numpy
from repro_torch.models.model import build_model

torch.set_num_threads(1)


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "qwen3-moe-235b-a22b", "llava-next-mistral-7b",
                                  "qwen3-14b", "qwen3-32b", "internlm2-1.8b",
                                  "kimi-k2-1t-a32b"])
def test_loss_and_gradients_match_jax_f32(arch):
    jcfg = jax_get_smoke_config(arch).scaled(dtype="float32")
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    jm = jax_build_model(jcfg, remat=False, attn_impl="chunked", ssd_impl="chunked")
    jparams = jm.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    model = build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((2, cfg.n_patches, cfg.d_model)).astype(np.float32)
    jl, jg = jax.value_and_grad(jm.loss)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(model.loss, params,
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    jg = {k: _np32(v) for k, v in named_leaves(jg)}
    grads = {k: _np32(v) for k, v in named_leaves(grads)}
    assert set(grads) == set(jg)
    for name, want in jg.items():
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(grads[name], want, atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=name)
        assert np.abs(grads[name]).max() > 0, f"{name}: zero gradient"
