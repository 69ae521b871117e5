"""The port's xlstm (mLSTM and sLSTM blocks, ``repro_torch.models.ssm``)
against the JAX model.

xlstm-350m SMOKE (4 layers ``xsxs``, d_model 64, 2 heads of 64, chunk 8)
with the reference's own weights carried across by ``params_from_numpy``;
the reference runs its SSD kernel in interpret mode.  One prefill of
B = 2, S = 12 (not a multiple of the chunk: the scan pads with identity
steps), then 4 greedy decode steps, both models fed the reference's tokens:

* float32: logits within atol = rtol = 1e-4 (float32 sums in another order;
  measured about 6e-7), greedy tokens equal; the mLSTM memory (C, n) and the
  sLSTM state (c, n, h, m) within the same tolerance;
* bfloat16: logits within atol = 0.12, rtol = 2e-2 (the two frameworks round
  to bfloat16 at other places, as in ``tests/test_torch_lm.py``).

Also: the full xlstm-350m parameter count on the meta device, and a ``cuda``
test (the kernel path against the CPU plain path with heads of 512, the
mLSTM's width: B4's tiled template) that runs only on a card.
"""

import numpy as np
import pytest
import torch

from _torch_zoo import batch, drive, f32, pair
from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.models.model import count_params as jax_count_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import build
from repro_torch.models.model import build_model, count_params

torch.set_num_threads(1)

ARCH = "xlstm-350m"
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
    if dtype == "float32":       # the recurrent states after the last step
        for unit, keys in (("u0", ("C", "n")), ("u1", ("c", "n", "h", "m"))):
            for key in keys:
                np.testing.assert_allclose(f32(cache["blocks"][unit][key]),
                                           f32(jcache["blocks"][unit][key]), **tol,
                                           err_msg=f"{unit}/{key}")


def test_full_config_param_count_on_meta():
    model = build_model(get_config(ARCH), device="meta")
    assert count_params(model) == jax_count_params(jax_build_model(jax_get_config(ARCH)))
    params = model.init_params()
    assert params["blocks"]["u0"]["mlstm"]["wq"].shape == (12, 2048, 2048)
    assert params["blocks"]["u1"]["slstm"]["r_h"].shape == (12, 4, 256, 1024)

    def nbytes(tree):
        return sum(nbytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
                   for v in tree.values())
    assert nbytes(params) == 733_007_872         # BENCH_ingest.json's param_bytes_total


# ---------------------------------------------------------------------- #
# on the card only
# ---------------------------------------------------------------------- #
@pytest.mark.cuda
def test_kernel_path_matches_cpu_plain_path_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    cfg = get_smoke_config(ARCH).scaled(dtype="float32", d_model=512, n_layers=2)   # ph = 512
    cpu = build_model(cfg, device="cpu")
    params = cpu.init_params(seed=0)
    tokens = torch.from_numpy(batch(cfg, 2, 70)["tokens"])
    want, _ = cpu.prefill(params, {"tokens": tokens})
    card = build_model(cfg, device="cuda")
    before = build.LAUNCHES["ssd_scan"]
    got, _ = card.prefill(_to(params), {"tokens": tokens})
    torch.cuda.synchronize()
    assert build.LAUNCHES["ssd_scan"] == before + 2                   # one mLSTM layer
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def _to(tree):
    return {k: _to(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.cuda()
