"""Sharded execution on real ranks: the LM zoo's prefill, decode and train
steps on a (data, model) ``DeviceMesh`` over spawned gloo ranks on the CPU.

Two worlds, each spawned once for the module (``repro_torch.launch.ranks``
holds their rank bodies) and run side by side: 8 ranks carry the
reference's ``small_test_mesh(2, 4)`` and (4, 2); 4 ranks carry (2, 2),
(1, 4) and (4, 1).  SMOKE internlm2-1.8b (GQA: 4 query heads on 2 KV heads,
so a 4-way ``model`` axis leaves the KV heads whole) and zamba2-7b (8 SSD
heads on 2 B/C groups, and its shared attention), float32, with the port's
``init_params(seed=0, host=True)`` weights; B = 8 prompts of 16 tokens from
``numpy.random.default_rng(0)``.

* Prefill into a cache of 24 (sequence-split over ``model``), then 3
  greedy decode steps: tokens equal, logits and cache within 1e-5 x max(1,
  |x|) of the single-process port (float32 sums in another order).
* The sharded ``value_and_grad`` of the loss and one train step
  (``TrainConfig(microbatches=2)``): loss within 1e-5 relative, gradients
  and every parameter leaf after the step within 1e-4 x max(1, max|x|) —
  ``tests/test_torch_zoo_train.py``'s float32 bounds — of the single-process
  port and of the reference (``jax.value_and_grad`` of its loss, and its
  ``make_train_fn`` step, in this process).
* Every rank's replicated values (metrics, gathered parameters, logits,
  cache) bit-equal; the cache and the train state at their shardings.
* The five faults of rank 0's offsets, each on ranks other than 0 of a
  (1, 4) mesh: the vocabulary-split loss, the sequence-split cache write,
  ``whole_product``'s backward, the flash backward's KV heads and the SSD
  backward's B/C groups.
* A checkpoint saved on (2, 4) restores onto (4, 2) bit for bit at the
  target's placements, and the reference's ``load_pytree`` reads it; a
  ``TrainLoop`` on (2, 2) resumed from its step-2 checkpoint through
  ``shardings=`` equals the uninterrupted 4-step run.
* The (2, 4) world's two train steps equal the reference's own sharded step
  on 8 XLA host devices (``tests/golden/torch_sharded_steps.json``, written
  by ``scripts/make_sharded_golden.py``): loss and grad_norm 1e-5 relative,
  leaf norms 1e-4 x max(1, |norm|).
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jax_load_pytree
from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.launch import steps as jax_steps
from repro.models.model import build_model as jax_build_model
from repro_torch import optim
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.kernels.flash.ops import flash_attention
from repro_torch.kernels.ssd.ops import ssd_scan
from repro_torch.launch import make_optimizer, make_train_fn, named_leaves, ranks, value_and_grad
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.models.model import build_model
from repro_torch.parallel.data import run_ranks

torch.set_num_threads(1)

ARCHS = ("internlm2-1.8b", "zamba2-7b")
WORLDS = {8: ((2, 4), (4, 2)), 4: ((2, 2), (1, 4), (4, 1))}
CELLS = [(m, a) for n in WORLDS for m in WORLDS[n] for a in ARCHS]
B, S, MAX_LEN, DECODE = 8, 16, 24, 3
TOL_STEP = 1e-5          # logits, cache: x max(1, |x|)
TOL_LOSS = 1e-5          # relative
TOL_LEAF = 1e-4          # x max(1, max|x|)
GOLDEN = json.loads((Path(__file__).parent / "golden" / "torch_sharded_steps.json").read_text())


def _id(cell) -> str:
    (d, m), arch = cell
    return f"{d}x{m}-{arch}"


def _tokens() -> np.ndarray:
    return np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)


def _params(arch: str) -> dict:
    model = build_model(get_smoke_config(arch).scaled(dtype="float32"), device="cpu")
    return optim.tree_map(lambda t: t.numpy(), model.init_params(seed=0, host=True))


def _flat(tree) -> dict:
    return {name: np.asarray(v) for name, v in named_leaves(tree)}


def _within(got, want, tol, what, rel_to_max=True):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if rel_to_max else 1.0
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * scale, f"{what}: max error {err:.3g} > {tol * scale:.3g}"


# ----------------------------------------------------------------- inputs
def _fault_inputs() -> dict:
    rng = np.random.default_rng(1)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {
        # vocabulary of 16 split 4 ways; every label in rows 4-15 (ranks 1-3)
        "nll": {"logits": f(2, 3, 16), "labels": rng.integers(4, 16, (2, 3)).astype(np.int64)},
        # a sequence of 8 split 4 ways (2 a rank); positions 3-5: ranks 1 and 2
        "seq": {"cache": f(2, 8, 2, 4), "val": f(2, 3, 2, 4), "start": 3},
        "product": {"x": f(2, 3, 8), "w": f(8, 12)},
        # 4 query heads split 4 ways on 2 whole KV heads: ranks 2, 3 read head 1
        "flash": {"q": f(2, 4, 6, 8), "k": f(2, 2, 6, 8), "v": f(2, 2, 6, 8),
                  "dout": f(2, 4, 6, 8)},
        # 8 SSD heads split 4 ways on 2 whole groups: ranks 2, 3 read group 1
        "ssd": {"x": f(2, 16, 8, 4), "dt": rng.uniform(0.1, 0.5, (2, 16, 8)).astype(np.float32),
                "A": rng.uniform(0.5, 1.5, (8,)).astype(np.float32), "B": f(2, 16, 2, 6),
                "C": f(2, 16, 2, 6), "dy": f(2, 16, 8, 4), "chunk": 8},
    }


def _jobs(n: int, params: dict, tokens: np.ndarray, tmp: Path) -> list:
    """The steps of each (mesh, arch) cell in world ``n``, then the world's
    other jobs: (2, 4) internlm2 also trains a second step (the golden
    file's) and saves its state, restored onto (4, 2)."""
    jobs = []
    for mesh in WORLDS[n]:
        for arch in ARCHS:
            golden = (mesh, arch) == (tuple(GOLDEN["mesh"].values()), GOLDEN["arch"])
            jobs.append(dict(kind="steps", arch=arch, mesh=mesh, tokens=tokens,
                             params=params[arch], max_len=MAX_LEN, decode=DECODE,
                             train=len(GOLDEN["steps"]) if golden else 1, grads=True,
                             **(dict(save_dir=str(tmp / "ckpt"), resume_mesh=(4, 2))
                                if golden else {})))
    if n == 4:
        jobs.append(dict(kind="train_loop", arch="internlm2-1.8b", mesh=(2, 2),
                         directory=str(tmp / "loop"), steps=4, stop=2, batch=B, seq=S,
                         params=params["internlm2-1.8b"]))
        jobs.append(dict(kind="faults", mesh=(1, 4), **_fault_inputs()))
        jobs.append(dict(kind="collectives", mesh=(1, 4)))
    return jobs


# ------------------------------------------------------------ single process
def _single(arch: str, params: dict, tokens: np.ndarray) -> dict:
    """The port in this process: prefill, greedy decode, value_and_grad and
    one train step."""
    from repro_torch.models.lm import params_from_numpy
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    model = build_model(cfg, device="cpu")
    p = params_from_numpy(cfg, params, "cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    out = {}
    logits, cache = model.prefill(p, batch, max_len=MAX_LEN)
    out["prefill/logits"] = logits.numpy()
    out.update({f"prefill/cache/{k}": v.numpy().copy() for k, v in named_leaves(cache)})
    for i in range(DECODE):
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        out[f"decode/{i}/token"] = tok.numpy()
        logits, cache = model.decode_step(p, tok, cache, S + i)
        out[f"decode/{i}/logits"] = logits.numpy()
    out.update({f"decode/cache/{k}": v.numpy() for k, v in named_leaves(cache)})
    loss, grads = value_and_grad(model.loss, p, batch)
    out["grads/loss"] = loss.numpy()
    out.update({f"grads/{k}": v.numpy() for k, v in named_leaves(grads)})
    tcfg = TrainConfig(microbatches=2)
    opt = make_optimizer(tcfg)
    new, _, m = make_train_fn(model, tcfg, opt)(p, opt.init(p), batch)
    out["train/0/loss"], out["train/0/grad_norm"] = m["loss"].numpy(), m["grad_norm"].numpy()
    out.update({f"train/params/{k}": v.numpy() for k, v in named_leaves(new)})
    return out


def _reference(arch: str, params: dict, tokens: np.ndarray) -> dict:
    """The JAX package on one device: ``jax.value_and_grad`` of its loss and
    one step of its ``make_train_fn``."""
    jcfg = jax_get_smoke_config(arch).scaled(dtype="float32")
    jm = jax_build_model(jcfg, remat=False, attn_impl="chunked", ssd_impl="chunked")
    jp = jax.tree.map(jnp.asarray, params)
    batch = {"tokens": jnp.asarray(tokens)}
    loss, grads = jax.value_and_grad(jm.loss)(jp, batch)
    tcfg = JaxTrainConfig(microbatches=2)
    opt = jax_steps.make_optimizer(tcfg)
    new, _, m = jax.jit(jax_steps.make_train_fn(jm, tcfg, opt))(jp, opt.init(jp), batch)
    out = {"grads/loss": np.asarray(loss), "train/0/loss": np.asarray(m["loss"]),
           "train/0/grad_norm": np.asarray(m["grad_norm"])}
    out.update({f"grads/{k}": np.asarray(v) for k, v in _flat(grads).items()})
    out.update({f"train/params/{k}": np.asarray(v) for k, v in _flat(new).items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    params = {arch: _params(arch) for arch in ARCHS}
    tokens = _tokens()
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        worlds = {n: pool.submit(run_ranks, ranks.run_jobs, n, backend="gloo", device="cpu",
                                 timeout_s=600, args=(_jobs(n, params, tokens, tmp),))
                  for n in WORLDS}
        single = {arch: _single(arch, params[arch], tokens) for arch in ARCHS}
        ref = {arch: _reference(arch, params[arch], tokens) for arch in ARCHS}
        results = {n: f.result() for n, f in worlds.items()}
    by_cell = {}
    for n, per_rank in results.items():
        for j, cell in enumerate((m, a) for m in WORLDS[n] for a in ARCHS):
            by_cell[cell] = [r[j] for r in per_rank]
    extra = {name: [r[len(WORLDS[4]) * len(ARCHS) + i] for r in results[4]]
             for i, name in enumerate(("train_loop", "faults", "collectives"))}
    return {"cells": by_cell, "single": single, "ref": ref, "params": params, "tmp": tmp,
            **extra}


# ------------------------------------------------------------ the steps
@pytest.mark.parametrize("cell", CELLS, ids=_id)
def test_prefill_and_decode_match_single_process(runs, cell):
    got, want = runs["cells"][cell][0], runs["single"][cell[1]]
    assert got["cache_at_shardings"]
    keys = [k for k in want if k.startswith(("prefill/", "decode/"))]
    assert len(keys) > 2 * DECODE + 2
    for k in keys:
        if k.endswith("/token"):
            assert np.array_equal(got["arrays"][k], want[k]), k
        else:
            _within(got["arrays"][k], want[k], TOL_STEP, k)


@pytest.mark.parametrize("cell", CELLS, ids=_id)
def test_gradients_match_single_process_and_reference(runs, cell):
    got = runs["cells"][cell][0]["arrays"]
    for want in (runs["single"][cell[1]], runs["ref"][cell[1]]):
        assert float(got["grads/loss"]) == pytest.approx(float(want["grads/loss"]), rel=TOL_LOSS)
        names = [k for k in want if k.startswith("grads/") and k != "grads/loss"]
        assert names and set(names) == {k for k in got if k.startswith("grads/")} - {"grads/loss"}
        for k in names:
            _within(got[k], want[k], TOL_LEAF, k)
            assert np.abs(got[k]).max() > 0, f"{k}: zero gradient"


@pytest.mark.parametrize("cell", CELLS, ids=_id)
def test_train_step_matches_single_process_and_reference(runs, cell):
    res = runs["cells"][cell][0]
    got = res["arrays"]
    assert res["train_at_shardings"]
    for want in (runs["single"][cell[1]], runs["ref"][cell[1]]):
        for k in ("train/0/loss", "train/0/grad_norm"):
            assert float(got[k]) == pytest.approx(float(want[k]), rel=TOL_LOSS), k
        names = [k for k in want if k.startswith("train/params/")]
        assert len(names) == len(res["train_leaf_names"])
        for k in names:
            _within(got[k], want[k], TOL_LEAF, k)


@pytest.mark.parametrize("cell", CELLS, ids=_id)
def test_replicated_values_bit_equal_across_ranks(runs, cell):
    per_rank = runs["cells"][cell]
    assert [r["rank"] for r in per_rank] == list(range(len(per_rank)))
    want = per_rank[0]["digests"]
    assert any(k.startswith("train/") for k in want) and any(k.startswith("decode/") for k in want)
    for r in per_rank[1:]:
        diff = [k for k in want if r["digests"].get(k) != want[k]]
        assert not diff, f"rank {r['rank']} differs from rank 0 in {diff[:5]}"


def test_reference_sharded_steps_golden(runs):
    """The (2, 4) world against the reference's own jitted sharded step."""
    res = runs["cells"][((2, 4), GOLDEN["arch"])][0]
    got = res["arrays"]
    flat = _flat(runs["params"][GOLDEN["arch"]])
    h = hashlib.sha256()
    for name in sorted(flat):
        h.update(name.encode())
        h.update(np.ascontiguousarray(flat[name]).tobytes())
    assert h.hexdigest() == GOLDEN["params_sha256"]
    assert GOLDEN["wq_shards"] == 8 and GOLDEN["devices"] == 8
    for i, step in enumerate(GOLDEN["steps"]):
        assert float(got[f"train/{i}/step"]) == step["step"]
        assert float(got[f"train/{i}/loss"]) == pytest.approx(step["loss"], rel=TOL_LOSS)
        assert float(got[f"train/{i}/grad_norm"]) == pytest.approx(step["grad_norm"],
                                                                   rel=TOL_LOSS)
        norms = dict(zip(res["train_leaf_names"], got[f"train/{i}/leaf_norms"]))
        assert set(norms) == set(step["leaf_norms"])
        for name, want in step["leaf_norms"].items():
            _within(norms[name], want, TOL_LEAF, f"step {i} {name}")


# ------------------------------------------------------------ faults 1-5
def test_fault1_vocab_split_loss_on_ranks_1_to_3(runs):
    """Rank 0's rows 0..n-1 read by every rank gave internlm2's (1, 4) loss
    0.052 off and zamba2's 0.183."""
    faults = runs["faults"]
    assert [f["model_rank"] for f in faults] == [0, 1, 2, 3]
    nll = _fault_inputs()["nll"]
    assert nll["labels"].min() >= 4            # no label in rank 0's rows
    want = softmax_cross_entropy(torch.from_numpy(nll["logits"]), torch.from_numpy(nll["labels"]))
    _within(faults[0]["arrays"]["nll/loss"], want.numpy(), 1e-6, "nll/loss")
    for arch in ARCHS:
        got = runs["cells"][((1, 4), arch)][0]["arrays"]
        assert float(got["grads/loss"]) == pytest.approx(
            float(runs["single"][arch]["grads/loss"]), rel=TOL_LOSS)


def test_fault2_sequence_split_cache_write_straddles_ranks_1_and_2(runs):
    seq = _fault_inputs()["seq"]
    want = seq["cache"].copy()
    want[:, seq["start"]: seq["start"] + seq["val"].shape[1]] = seq["val"]
    assert seq["start"] // 2 == 1 and (seq["start"] + 2) // 2 == 2     # owners: ranks 1, 2
    np.testing.assert_array_equal(runs["faults"][0]["arrays"]["seq/cache"], want)


def test_fault3_whole_product_backward_takes_each_ranks_columns(runs):
    inp = _fault_inputs()["product"]
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    w = torch.from_numpy(inp["w"]).requires_grad_(True)
    y = x @ w
    y.square().sum().backward()
    got = runs["faults"][0]["arrays"]
    for name, want in (("y", y.detach()), ("dx", x.grad), ("dw", w.grad)):
        _within(got[f"product/{name}"], want.numpy(), 1e-5, name)


def test_fault4_flash_backward_reads_each_ranks_kv_heads(runs):
    inp = {k: torch.from_numpy(v) for k, v in _fault_inputs()["flash"].items()}
    q, k, v = (inp[n].clone().requires_grad_(True) for n in ("q", "k", "v"))
    out = flash_attention(q, k, v, causal=True)
    out.backward(inp["dout"])
    got = runs["faults"][0]["arrays"]
    _within(got["flash/out"], out.detach().numpy(), 1e-5, "out")
    for name, t in (("dq", q), ("dk", k), ("dv", v)):
        _within(got[f"flash/{name}"], t.grad.numpy(), 1e-5, name)


def test_fault5_ssd_backward_reads_each_ranks_groups(runs):
    inp = _fault_inputs()["ssd"]
    t = {k: torch.from_numpy(inp[k]).requires_grad_(k != "dy") for k in
         ("x", "dt", "A", "B", "C", "dy")}
    y, h = ssd_scan(t["x"], t["dt"], t["A"], t["B"], t["C"], chunk=inp["chunk"])
    y.backward(t["dy"])
    got = runs["faults"][0]["arrays"]
    _within(got["ssd/y"], y.detach().numpy(), 1e-5, "y")
    _within(got["ssd/h"], h.detach().numpy(), 1e-5, "h")
    for name, key in (("dx", "x"), ("ddt", "dt"), ("dA", "A"), ("dB", "B"), ("dC", "C")):
        _within(got[f"ssd/{name}"], t[key].grad.numpy(), 1e-5, name)


def test_functional_collectives_and_the_shared_card_all_gather(runs):
    """The collectives DTensor issues, and the gloo shared card's all-gather
    called as itself, equal their host results on every rank."""
    for c in runs["collectives"]:
        assert c["backend"] == "gloo" and c["device"] == "cpu"
        assert c["ok"] == dict.fromkeys(("all_gather_into_tensor", "reduce_scatter_tensor",
                                         "all_reduce", "all_to_all_single",
                                         "shared_card_all_gather"), True)
        assert c["shared_card_uses"] == {"all_gather_into_tensor": 1}   # the direct call only


# ------------------------------------------------------------ checkpoints
def test_checkpoint_saved_on_2x4_restores_onto_4x2(runs):
    arch = GOLDEN["arch"]
    per_rank = runs["cells"][((2, 4), arch)]
    res = per_rank[0]
    assert res["resume"] == {"leaves": len(res["train_leaf_names"]) * 3 + 1,
                             "equal": len(res["train_leaf_names"]) * 3 + 1, "mesh": [4, 2],
                             "at_shardings": True}
    for r in per_rank[1:]:
        assert r["resume"] == res["resume"]
    restored = {k[len("restored/"):]: v for k, v in res["arrays"].items()
                if k.startswith("restored/")}
    # the reference reads the directory to the same arrays
    step_dir = runs["tmp"] / "ckpt" / f"step_{len(GOLDEN['steps']):08d}"
    params = jax.tree.map(jnp.asarray, runs["params"][arch])
    target = {"params": params,
              "opt_state": {"0": jnp.zeros((), jnp.int32), "1": params, "2": params}}
    jtree = _flat(jax_load_pytree(step_dir, target))
    assert set(jtree) == set(restored)
    for name, arr in jtree.items():
        np.testing.assert_array_equal(np.asarray(arr), restored[name], err_msg=name)
    want = dict(zip(res["train_leaf_names"], res["arrays"][f"train/{len(GOLDEN['steps']) - 1}"
                                                            "/leaf_norms"]))
    for name, norm in want.items():
        assert float(np.linalg.norm(restored[f"params/{name}"].astype(np.float64))) == \
            pytest.approx(norm, rel=1e-12)


def test_train_loop_resumed_through_shardings_equals_uninterrupted(runs):
    res = runs["train_loop"]
    r0 = res[0]
    assert r0["resumed_from"] == 2 and r0["resumed_at_shardings"]
    full = {k[5:]: v for k, v in r0["arrays"].items() if k.startswith("full/")}
    resumed = {k[8:]: v for k, v in r0["arrays"].items() if k.startswith("resumed/")}
    assert full and set(full) == set(resumed)
    for name in full:
        np.testing.assert_array_equal(resumed[name], full[name], err_msg=name)
    assert r0["metrics"]["full"]["final_step"] == r0["metrics"]["resumed"]["final_step"] == 4
    assert r0["metrics"]["full"]["loss"] == r0["metrics"]["resumed"]["loss"]
    for r in res[1:]:
        assert r["digests"] == r0["digests"]
