"""The port's LM training path (``Model.loss``, ``launch.make_train_fn``)
against the JAX package's.

The three ported SMOKE architectures (zamba2-7b "mmmmmA", whisper-tiny 2 + 2
layers, xlstm-350m "xsxs"), the reference built with ``remat=False,
attn_impl="chunked", ssd_impl="chunked"`` (its CPU training route: the
flash custom VJP and autodiff of the chunked SSD) and its own ``init_params``
weights carried across by ``params_from_numpy``; batches drawn with numpy
from a seed:

* float32: the loss within rtol = 1e-5, every parameter leaf's gradient
  within atol = rtol = 1e-4 x max(1, max|g|) of ``jax.value_and_grad``'s
  (float32 sums in another order, amplified through xlstm's exponential
  gates: measured at most 6.1e-5 there, 1.1e-6 elsewhere);
* ``make_train_fn`` with two microbatches against the reference's under
  ``jax.jit`` for three steps (whisper-tiny): metrics within 1e-5 relative,
  every parameter within atol = 1e-4 after each step (AdamW's normalized
  step turns a float32 difference in a near-zero gradient into a difference
  of up to the step's size, lr <= 3e-4 here; measured 1.7e-5);
* the golden file ``tests/golden/torch_lm_train_steps.json``
  (``scripts/make_lm_train_golden.py``, the reference's three steps from the
  port's host-drawn weights, whose sha256 and each step's tokens it
  records; both equal here, the stream's tokens bit for bit): each step's
  loss within 1e-4 relative, its
  grad_norm within 1e-3 relative and every leaf's L2 norm after step 3
  within 1e-4 relative (float32 in another order; measured on the CPU at
  most 1.7e-7, 2.8e-5 and 5.5e-7: the grad norm of xlstm's third step moves
  most).  ``chip_smoke.py`` holds the card's float32 kernel path to the
  same file at these tolerances.

The bfloat16 case is ``tests/test_torch_lm_train_bf16.py``.  A ``cuda``
test checks that a grad-requiring input reaches B3 and B4 only
through their autograd Functions on the card.
"""

import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.launch import steps as jax_steps
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.data import TokenStream
from repro_torch.kernels import build
from repro_torch.launch import make_optimizer, make_train_fn, named_leaves, value_and_grad
from repro_torch.models.lm import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.train_lm import batch_fn_for

torch.set_num_threads(1)

ARCHS = ("zamba2-7b", "whisper-tiny", "xlstm-350m")
GOLDEN = Path(__file__).parent / "golden" / "torch_lm_train_steps.json"
B, S = 2, 12          # 12: not a multiple of the SSD chunk (8)


def _named(tree):
    return dict(named_leaves(tree))


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _pair(arch, dtype, jparams=None):
    jcfg = jax_get_smoke_config(arch).scaled(dtype=dtype)
    cfg = get_smoke_config(arch).scaled(dtype=dtype)
    jm = jax_build_model(jcfg, remat=False, attn_impl="chunked", ssd_impl="chunked")
    if jparams is None:
        jparams = jm.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jm, jparams, build_model(cfg, device="cpu"), params


def _batch(cfg, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        out["audio_embed"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    if mask:
        out["loss_mask"] = (rng.random((B, S)) < 0.6).astype(np.float32)
    return out


def _losses_and_grads(jm, jparams, model, params, batch):
    jl, jg = jax.value_and_grad(jm.loss)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(model.loss, params, {k: torch.from_numpy(v)
                                                      for k, v in batch.items()})
    return float(jl), {k: _np32(v) for k, v in _named(jg).items()}, float(loss), \
        {k: _np32(v) for k, v in _named(grads).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_f32(arch):
    jm, jparams, model, params = _pair(arch, "float32")
    mask = arch == "zamba2-7b"              # the loss_mask route, on one arch
    jl, jg, loss, grads = _losses_and_grads(jm, jparams, model, params,
                                            _batch(model.cfg, mask=mask))
    assert loss == pytest.approx(jl, rel=1e-5)
    assert set(grads) == set(jg)
    for name, want in jg.items():
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(grads[name], want, atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=name)
        assert np.abs(grads[name]).max() > 0, f"{name}: zero gradient"


def _jax_train(arch, jparams, steps, stream):
    jm, _, _, _ = _pair(arch, "float32", jparams)
    tcfg = JaxTrainConfig(microbatches=2, lr=1e-3, warmup_steps=10, total_steps=50,
                          weight_decay=0.01)
    opt = jax_steps.make_optimizer(tcfg)
    fn = jax.jit(jax_steps.make_train_fn(jm, tcfg, opt))
    state, out = opt.init(jparams), []
    for step in range(steps):
        batch = {k: jnp.asarray(v) for k, v in stream.batch_at(step).items()}
        if jm.cfg.family == "audio":
            batch["audio_embed"] = jnp.zeros((stream.local_batch, jm.cfg.encoder_seq,
                                              jm.cfg.d_model), jnp.bfloat16)
        jparams, state, metrics = fn(jparams, state, batch)
        out.append(({k: float(v) for k, v in metrics.items()},
                    {k: np.asarray(v) for k, v in _named(jparams).items()}))
    return out


def _port_steps(cfg, params, steps, stream):
    model = build_model(cfg, device="cpu")
    tcfg = TrainConfig(microbatches=2, lr=1e-3, warmup_steps=10, total_steps=50,
                       weight_decay=0.01)
    opt = make_optimizer(tcfg)
    fn, state = make_train_fn(model, tcfg, opt), opt.init(params)
    batch_fn = batch_fn_for(cfg, stream, model.device)
    for step in range(steps):
        params, state, metrics = fn(params, state, batch_fn(step))
        yield {k: float(v) for k, v in metrics.items()}, params


def _params_sha256(params) -> str:
    h = hashlib.sha256()
    for _, leaf in named_leaves(params):
        h.update(np.ascontiguousarray(leaf.float().numpy(), dtype="<f4").tobytes())
    return h.hexdigest()


def test_train_fn_matches_jax_for_three_steps():
    arch = "whisper-tiny"
    jm, jparams, model, params = _pair(arch, "float32")
    stream = TokenStream(vocab_size=model.cfg.vocab_size, seq_len=16, global_batch=4, seed=0)
    want = _jax_train(arch, jparams, 3, stream)
    for (metrics, got), (jmetrics, jleaves) in zip(_port_steps(model.cfg, params, 3, stream),
                                                   want):
        for k in ("loss", "grad_norm", "step"):
            assert metrics[k] == pytest.approx(jmetrics[k], rel=1e-5), k
        for name, leaf in _named(got).items():
            np.testing.assert_allclose(_np32(leaf), jleaves[name], atol=1e-4, rtol=0,
                                       err_msg=name)


def test_train_config_refuses_gradient_compression():
    """``grad_compression`` belongs to data parallelism, which the port does
    not have: a value other than None raises instead of being ignored."""
    assert TrainConfig(microbatches=2).grad_compression is None
    with pytest.raises(NotImplementedError, match="data parallelism"):
        TrainConfig(grad_compression="int8")


@pytest.mark.parametrize("arch", ARCHS)
def test_port_matches_golden_steps(arch):
    golden = json.loads(GOLDEN.read_text())
    conf, rec = golden["config"], golden["archs"][arch]
    cfg = get_smoke_config(arch).scaled(dtype=conf["dtype"])
    params = build_model(cfg, device="cpu").init_params(seed=conf["seed"], host=True)
    assert _params_sha256(params) == rec["init_sha256"]
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=conf["seq"],
                         global_batch=conf["batch"], seed=conf["stream_seed"])
    for step, want in enumerate(rec["steps"]):
        assert stream.batch_at(step)["tokens"].tolist() == want["tokens"]
    for (metrics, params), want in zip(_port_steps(cfg, params, conf["steps"], stream),
                                       rec["steps"]):
        assert metrics["loss"] == pytest.approx(want["loss"], rel=1e-4)
        assert metrics["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-3)
        assert metrics["step"] == want["step"]
    norms = {n: float(np.linalg.norm(t.double().numpy().ravel())) for n, t in named_leaves(params)}
    assert set(norms) == set(rec["leaf_norms"])
    for name, want in rec["leaf_norms"].items():
        assert norms[name] == pytest.approx(want, rel=1e-4), name


@pytest.mark.cuda
def test_grad_inputs_reach_the_kernels_only_through_the_functions():
    """On the card, a float32 zamba2 smoke loss under autograd launches B3
    and B4 (through the Functions: the parameters get gradients through the
    attention and the scans), while the kernel wrappers called directly
    with grad-requiring inputs raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    from repro_torch.kernels.flash.kernel import flash_attention_cuda
    from repro_torch.kernels.ssd.kernel import ssd_scan_cuda
    cfg = get_smoke_config("zamba2-7b").scaled(dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init_params(seed=0)
    tokens = torch.from_numpy(_batch(cfg)["tokens"]).cuda()
    before = dict(build.LAUNCHES)
    loss, grads = value_and_grad(model.loss, params, {"tokens": tokens})
    assert build.LAUNCHES["flash_fwd"] > before["flash_fwd"]
    assert build.LAUNCHES["ssd_scan"] > before["ssd_scan"]
    g = _named(grads)
    assert float(g["shared_attn/attn/wq"].abs().sum()) > 0
    assert float(g["blocks/u0/mamba/a_log"].abs().sum()) > 0
    q = torch.randn((1, 2, 8, 16), device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention_cuda(q, q, q)
    x = torch.randn((1, 8, 2, 4), device="cuda", requires_grad=True)
    bc = torch.randn((1, 8, 1, 4), device="cuda")
    with pytest.raises(RuntimeError, match="no gradient"):
        ssd_scan_cuda(x, torch.rand((1, 8, 2), device="cuda"), torch.ones(2, device="cuda"),
                      bc, bc, chunk=8)
