"""Activation remat: ``build_model(cfg, remat=True)``, the reference's
default, against ``remat=False`` and the JAX package's
``jax.value_and_grad`` of its own ``build_model(cfg)``.

One SMOKE float32 model of each family: internlm2-1.8b (GQA), minicpm3-4b
(MLA), qwen3-moe-235b-a22b (the MoE dispatch), zamba2-7b (the hybrid: B4
and the shared attention block), xlstm-350m (the sLSTM's scan and B4's
tiled mLSTM) and whisper-tiny (the encoder's and the decoder's layers), the
reference's ``init_params`` weights carried across by ``params_from_numpy``
and a numpy batch from a seed:

* the loss and every gradient with ``remat=True`` bit-equal to
  ``remat=False`` on the CPU (the recompute runs the same operations on the
  same inputs);
* within 1e-4 x max(1, max|g|) of the reference with its default remat
  (``attn_impl="chunked", ssd_impl="chunked"``, its CPU training route), the
  loss within 1e-5 relative;
* fewer bytes saved for the backward with remat on, counted by
  ``torch.autograd.graph.saved_tensors_hooks`` outside the rematerialized
  bodies: the unit bodies keep nothing;
* a step of ``make_train_fn`` with two microbatches bit-equal with remat on
  and off;
* prefill and decode never remat; ingest traces with ``remat=False`` as the
  reference's ingest does, and its golden graph hashes stay as they were.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.launch import make_optimizer, make_train_fn, named_leaves, value_and_grad
from repro_torch.models.lm import params_from_numpy
from repro_torch.models.model import build_model

torch.set_num_threads(1)

ARCHS = ("internlm2-1.8b", "minicpm3-4b", "qwen3-moe-235b-a22b", "zamba2-7b", "xlstm-350m",
         "whisper-tiny")
B, S = 2, 12
TOL_GRAD = 1e-4         # x max(1, max|g|): float32 sums in another order
TOL_LOSS = 1e-5         # relative
INGEST_HASHES = Path(__file__).parent / "golden" / "torch_ingest_hashes.json"


def _batch(cfg) -> dict:
    rng = np.random.default_rng(3)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        out["audio_embed"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(arch, reference loss and gradients, the port's params and batch)."""
    arch = request.param
    jm = jax_build_model(jax_get_smoke_config(arch).scaled(dtype="float32"),
                         attn_impl="chunked", ssd_impl="chunked")          # remat on
    jparams = jm.init_params(jax.random.PRNGKey(0))
    batch = _batch(get_smoke_config(arch))
    jl, jg = jax.value_and_grad(jm.loss)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return arch, float(jl), {k: np.asarray(v) for k, v in named_leaves(jg)}, cfg, params, {
        k: torch.from_numpy(v) for k, v in batch.items()}


def _loss_and_grads(cfg, params, batch, remat: bool):
    """(loss, gradients by name, bytes saved for the backward outside any
    rematerialized body)."""
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t
    model = build_model(cfg, device="cpu", remat=remat)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, grads = value_and_grad(model.loss, params, batch)
    return loss, dict(named_leaves(grads)), saved[0]


def test_remat_is_bit_equal_and_saves_less(case):
    arch, _, _, cfg, params, batch = case
    l0, g0, saved0 = _loss_and_grads(cfg, params, batch, remat=False)
    l1, g1, saved1 = _loss_and_grads(cfg, params, batch, remat=True)
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    print(f"{arch}: bytes saved for the backward {saved0} without remat, {saved1} with")
    assert 0 < saved1 < saved0


def test_remat_matches_reference_default(case):
    arch, jl, jg, cfg, params, batch = case
    loss, grads, _ = _loss_and_grads(cfg, params, batch, remat=True)
    assert float(loss) == pytest.approx(jl, rel=TOL_LOSS)
    assert set(grads) == set(jg)
    for name, want in jg.items():
        got = grads[name].detach().numpy()
        err = float(np.abs(got - want).max())
        assert err <= TOL_GRAD * max(1.0, float(np.abs(want).max())), (arch, name, err)


@pytest.mark.parametrize("arch", ("internlm2-1.8b", "qwen3-moe-235b-a22b"))
def test_train_step_bit_equal(arch):
    """``make_train_fn`` with two microbatches: parameters, optimizer state
    and metrics after one step equal with remat on and off."""
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    tcfg = TrainConfig(microbatches=2)
    opt = make_optimizer(tcfg)
    out = []
    for remat in (False, True):
        model = build_model(cfg, device="cpu", remat=remat)
        params = model.init_params(seed=0)
        out.append(make_train_fn(model, tcfg, opt)(params, opt.init(params), batch))
    (p0, s0, m0), (p1, s1, m1) = out
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for (name, a), (_, b) in zip(named_leaves(p0) + named_leaves(s0.tree()),
                                 named_leaves(p1) + named_leaves(s1.tree())):
        assert (a is None and b is None) or torch.equal(a, b), name


def test_remat_default_and_serving_paths():
    """``remat`` is on by default; prefill and decode run no checkpoint (the
    same logits and cache under either setting, nothing recomputed)."""
    cfg = get_smoke_config("internlm2-1.8b").scaled(dtype="float32")
    assert build_model(cfg, device="cpu").remat is True
    batch = {"tokens": torch.from_numpy(_batch(cfg)["tokens"])}
    res = []
    for remat in (False, True):
        model = build_model(cfg, device="cpu", remat=remat)
        params = model.init_params(seed=0)
        logits, cache = model.prefill(params, batch, max_len=S + 1)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        step, cache = model.decode_step(params, tok, cache, S)
        res.append((logits, step, dict(named_leaves(cache))))
    assert torch.equal(res[0][0], res[1][0]) and torch.equal(res[0][1], res[1][1])
    assert all(torch.equal(res[0][2][k], res[1][2][k]) for k in res[0][2])


def test_ingest_traces_without_remat_and_its_hashes_hold():
    """Ingest builds its model with ``remat=False``, as the reference's
    ``trace_model`` does: the train kind's forward trace is the same program
    either way, and the golden graph hashes of the full configs are
    unchanged."""
    from repro_torch.ingest import coarsen_program, ingest_model, trace_model
    from repro_torch.ingest import trace as trace_mod
    first = trace_model("internlm2-1.8b", kind="train").program
    orig = trace_mod.build_model
    try:
        trace_mod.build_model = lambda cfg, device=None, remat=True: orig(cfg, device, remat=True)
        again = trace_model("internlm2-1.8b", kind="train").program
    finally:
        trace_mod.build_model = orig
    assert len(first.instructions) == len(again.instructions)
    assert coarsen_program(first, 12).content_hash() == coarsen_program(again, 12).content_hash()
    golden = json.loads(INGEST_HASHES.read_text())
    got = ingest_model("whisper-tiny", 12, smoke=False, seq_len=golden["seq_len"]).report
    assert got["graph_hash"] == golden["graph_hash"]["whisper-tiny"]["12"]
