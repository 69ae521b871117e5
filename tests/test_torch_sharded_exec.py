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
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_ranks import (B, DECODE, GOLDEN, S, TOL_LEAF, TOL_LOSS, cell_id,
                          check_gradients, check_prefill_and_decode, check_replicated,
                          check_train_step, flat, params, params_sha256, reference, single,
                          within)

from repro.checkpoint import load_pytree as jax_load_pytree
from repro_torch.kernels.flash.ops import flash_attention
from repro_torch.kernels.ssd.ops import ssd_scan
from repro_torch.launch import ranks
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.parallel.data import run_ranks

torch.set_num_threads(1)

ARCHS = ("internlm2-1.8b", "zamba2-7b")
WORLDS = {8: ((2, 4), (4, 2)), 4: ((2, 2), (1, 4), (4, 1))}
CELLS = [(m, a) for n in WORLDS for m in WORLDS[n] for a in ARCHS]
MAX_LEN = 24             # a cache the 4-way model axis splits along the sequence


def _tokens() -> np.ndarray:
    return np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    prm = {arch: params(arch) for arch in ARCHS}
    tokens = _tokens()
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        worlds = {n: pool.submit(run_ranks, ranks.run_jobs, n, backend="gloo", device="cpu",
                                 timeout_s=600, args=(_jobs(n, prm, tokens, tmp),))
                  for n in WORLDS}
        single_ = {arch: single(arch, prm[arch], {"tokens": tokens}, MAX_LEN) for arch in ARCHS}
        ref = {arch: reference(arch, prm[arch], {"tokens": tokens}) for arch in ARCHS}
        results = {n: f.result() for n, f in worlds.items()}
    by_cell = {}
    for n, per_rank in results.items():
        for j, cell in enumerate((m, a) for m in WORLDS[n] for a in ARCHS):
            by_cell[cell] = [r[j] for r in per_rank]
    extra = {name: [r[len(WORLDS[4]) * len(ARCHS) + i] for r in results[4]]
             for i, name in enumerate(("train_loop", "faults", "collectives"))}
    return {"cells": by_cell, "single": single_, "ref": ref, "params": prm, "tmp": tmp,
            **extra}


# ------------------------------------------------------------ the steps
@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_prefill_and_decode_match_single_process(runs, cell):
    check_prefill_and_decode(runs, cell)


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_gradients_match_single_process_and_reference(runs, cell):
    check_gradients(runs, cell)


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_train_step_matches_single_process_and_reference(runs, cell):
    check_train_step(runs, cell)


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_replicated_values_bit_equal_across_ranks(runs, cell):
    check_replicated(runs, cell)


def test_reference_sharded_steps_golden(runs):
    """The (2, 4) world against the reference's own jitted sharded step."""
    res = runs["cells"][((2, 4), GOLDEN["arch"])][0]
    got = res["arrays"]
    assert params_sha256(runs["params"][GOLDEN["arch"]]) == GOLDEN["params_sha256"]
    assert GOLDEN["wq_shards"] == 8 and GOLDEN["devices"] == 8
    for i, step in enumerate(GOLDEN["steps"]):
        assert float(got[f"train/{i}/step"]) == step["step"]
        assert float(got[f"train/{i}/loss"]) == pytest.approx(step["loss"], rel=TOL_LOSS)
        assert float(got[f"train/{i}/grad_norm"]) == pytest.approx(step["grad_norm"],
                                                                   rel=TOL_LOSS)
        norms = dict(zip(res["train_leaf_names"], got[f"train/{i}/leaf_norms"]))
        assert set(norms) == set(step["leaf_norms"])
        for name, want in step["leaf_norms"].items():
            within(norms[name], want, TOL_LEAF, f"step {i} {name}")


# ------------------------------------------------------------ faults 1-5
def test_fault1_vocab_split_loss_on_ranks_1_to_3(runs):
    """Rank 0's rows 0..n-1 read by every rank gave internlm2's (1, 4) loss
    0.052 off and zamba2's 0.183."""
    faults = runs["faults"]
    assert [f["model_rank"] for f in faults] == [0, 1, 2, 3]
    nll = _fault_inputs()["nll"]
    assert nll["labels"].min() >= 4            # no label in rank 0's rows
    want = softmax_cross_entropy(torch.from_numpy(nll["logits"]), torch.from_numpy(nll["labels"]))
    within(faults[0]["arrays"]["nll/loss"], want.numpy(), 1e-6, "nll/loss")
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
        within(got[f"product/{name}"], want.numpy(), 1e-5, name)


def test_fault4_flash_backward_reads_each_ranks_kv_heads(runs):
    inp = {k: torch.from_numpy(v) for k, v in _fault_inputs()["flash"].items()}
    q, k, v = (inp[n].clone().requires_grad_(True) for n in ("q", "k", "v"))
    out = flash_attention(q, k, v, causal=True)
    out.backward(inp["dout"])
    got = runs["faults"][0]["arrays"]
    within(got["flash/out"], out.detach().numpy(), 1e-5, "out")
    for name, t in (("dq", q), ("dk", k), ("dv", v)):
        within(got[f"flash/{name}"], t.grad.numpy(), 1e-5, name)


def test_fault5_ssd_backward_reads_each_ranks_groups(runs):
    inp = _fault_inputs()["ssd"]
    t = {k: torch.from_numpy(inp[k]).requires_grad_(k != "dy") for k in
         ("x", "dt", "A", "B", "C", "dy")}
    y, h = ssd_scan(t["x"], t["dt"], t["A"], t["B"], t["C"], chunk=inp["chunk"])
    y.backward(t["dy"])
    got = runs["faults"][0]["arrays"]
    within(got["ssd/y"], y.detach().numpy(), 1e-5, "y")
    within(got["ssd/h"], h.detach().numpy(), 1e-5, "h")
    for name, key in (("dx", "x"), ("ddt", "dt"), ("dA", "A"), ("dB", "B"), ("dC", "C")):
        within(got[f"ssd/{name}"], t[key].grad.numpy(), 1e-5, name)


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
    jtree = flat(jax_load_pytree(step_dir, target))
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
