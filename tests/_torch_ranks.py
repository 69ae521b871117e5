"""Shared by the sharded-execution tests (``tests/test_torch_sharded_exec.py``,
``_ssm.py``, ``_vlm.py``): the inputs, the single-process port and the
reference in the test's own process, the checks and their bounds.  The later
archs' files run one world of four gloo ranks on the CPU, spawned once a
module, over each arch's steps on the (1, 4) and (2, 2) meshes
(``repro_torch.launch.ranks``, :func:`run`); the first file keeps its own
worlds and jobs.

The inputs: the port's ``init_params(seed=0, host=True)`` weights (SMOKE,
float32), B = 8 prompts of 16 tokens from ``numpy.random.default_rng(0)``
and the model's other inputs (whisper's frames, the VLM's patches) drawn by
``ranks.model_inputs`` from the same seed, in bfloat16 as the reference's
``input_specs`` give them.  The bounds: logits and cache 1e-5 x max(1,
|x|), loss 1e-5 relative, gradients and parameters after a step 1e-4 x
max(1, max|x|) (float32 sums in another order, and for the gradients in
another microbatch split)."""

from __future__ import annotations

import concurrent.futures
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
from repro_torch import optim
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.launch import make_optimizer, make_train_fn, named_leaves, ranks, value_and_grad
from repro_torch.models.lm import params_from_numpy
from repro_torch.models.mlp import recorded_routes
from repro_torch.models.model import build_model
from repro_torch.parallel.data import run_ranks

MESHES = ((1, 4), (2, 2))
B, S, DECODE = 8, 16, 3
TOL_STEP = 1e-5          # logits, cache: x max(1, |x|)
TOL_LOSS = 1e-5          # relative
TOL_LEAF = 1e-4          # x max(1, max|x|)
#: the MoE archs' SMOKE capacity factor in the rank tests: small enough that
#: every step drops slots (the default 1.25 leaves some steps without drops)
MOE_CAPACITY = {"qwen3-moe-235b-a22b": 1.0, "kimi-k2-1t-a32b": 1.0}
GOLDEN = json.loads((Path(__file__).parent / "golden" / "torch_sharded_steps.json").read_text())


def cell_id(cell) -> str:
    (d, m), arch = cell
    return f"{d}x{m}-{arch}"


def smoke_config(arch: str):
    """``arch``'s SMOKE config in float32 (an MoE at :data:`MOE_CAPACITY`)."""
    return ranks.config_of(arch, capacity_factor=MOE_CAPACITY.get(arch))


def model(arch: str, remat: bool = False):
    return build_model(smoke_config(arch), device="cpu", remat=remat)


def params(arch: str) -> dict:
    return optim.tree_map(lambda t: t.numpy(), model(arch).init_params(seed=0, host=True))


def inputs(arch: str) -> dict:
    """The numpy batch: tokens, and the model's other inputs in float32."""
    toks = np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)
    return ranks.model_inputs(model(arch), toks, seed=0)


def flat(tree) -> dict:
    return {name: np.asarray(v) for name, v in named_leaves(tree)}


def within(got, want, tol, what, rel_to_max=True):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if rel_to_max else 1.0
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * scale, f"{what}: max error {err:.3g} > {tol * scale:.3g}"


def golden_steps(arch: str) -> bool:
    return arch in GOLDEN.get("archs", {})


def step_jobs(archs, prm: dict, arrays: dict, remat: bool = False) -> list:
    """A steps job a (mesh, arch) cell: prefill, greedy decode, the sharded
    ``value_and_grad`` and train steps (two where the golden file holds the
    reference's own sharded steps, on (2, 2): the same global batch as its
    (2, 4)); with ``remat`` the loss rematerializes its unit bodies."""
    jobs = []
    for mesh in MESHES:
        for arch in archs:
            n_train = len(GOLDEN["archs"][arch]["steps"]) if golden_steps(arch) and \
                mesh == (2, 2) else 1
            tokens = arrays[arch]["tokens"]
            jobs.append(dict(kind="steps", arch=arch, mesh=mesh, tokens=tokens,
                             inputs={k: v for k, v in arrays[arch].items() if k != "tokens"},
                             params=prm[arch], max_len=ranks.n_prefix(
                                 get_smoke_config(arch)) + S + DECODE,
                             decode=DECODE, train=n_train, grads=True, remat=remat,
                             capacity_factor=MOE_CAPACITY.get(arch)))
    return jobs


def single(arch: str, prm: dict, arrays: dict, max_len: int | None = None,
           remat: bool = False) -> dict:
    """The port in this process: prefill (into a cache of ``max_len``,
    default the prompt and the decode steps), greedy decode, value_and_grad
    and one train step."""
    mdl = model(arch, remat)
    cfg = mdl.cfg
    p = params_from_numpy(cfg, prm, "cpu")
    specs, _ = ranks.input_records(mdl, B, S)
    batch = ranks.batch_of(arrays, specs, "cpu")
    s = S + ranks.n_prefix(cfg)
    out = {}
    def put(name, t):
        out[name] = ranks.numpy_of(t)

    with recorded_routes() as routes:
        logits, cache = mdl.prefill(p, batch, max_len=max_len or s + DECODE)
    out["prefill/logits"] = logits.numpy()
    ranks.put_routes(put, "prefill", routes)
    out.update({f"prefill/cache/{k}": v.numpy().copy() for k, v in named_leaves(cache)})
    for i in range(DECODE):
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        out[f"decode/{i}/token"] = tok.numpy()
        with recorded_routes() as routes:
            logits, cache = mdl.decode_step(p, tok, cache, s + i)
        out[f"decode/{i}/logits"] = logits.numpy()
        ranks.put_routes(put, f"decode/{i}", routes)
    out.update({f"decode/cache/{k}": v.numpy() for k, v in named_leaves(cache)})
    loss, grads = value_and_grad(mdl.loss, p, batch)
    out["grads/loss"] = loss.numpy()
    out.update({f"grads/{k}": v.numpy() for k, v in named_leaves(grads)})
    tcfg = TrainConfig(microbatches=2)
    opt = make_optimizer(tcfg)
    new, _, m = make_train_fn(mdl, tcfg, opt)(p, opt.init(p), batch)
    out["train/0/loss"], out["train/0/grad_norm"] = m["loss"].numpy(), m["grad_norm"].numpy()
    out.update({f"train/params/{k}": v.numpy() for k, v in named_leaves(new)})
    return out


def reference_config(arch: str):
    """The reference's SMOKE config of ``arch`` as :func:`smoke_config`'s."""
    import dataclasses
    jcfg = jax_get_smoke_config(arch).scaled(dtype="float32")
    if arch in MOE_CAPACITY:
        jcfg = jcfg.scaled(moe=dataclasses.replace(jcfg.moe, capacity_factor=MOE_CAPACITY[arch]))
    return jcfg


def reference(arch: str, prm: dict, arrays: dict, remat: bool = False) -> dict:
    """The JAX package on one device: ``jax.value_and_grad`` of its loss and
    one step of its ``make_train_fn``, on the same batch (the frames and
    patches in bfloat16)."""
    jm = jax_build_model(reference_config(arch), remat=remat, attn_impl="chunked",
                         ssd_impl="chunked")
    jp = jax.tree.map(jnp.asarray, prm)
    batch = {k: jnp.asarray(v) if k == "tokens" else jnp.asarray(v, jnp.bfloat16)
             for k, v in arrays.items()}
    loss, grads = jax.value_and_grad(jm.loss)(jp, batch)
    tcfg = JaxTrainConfig(microbatches=2)
    opt = jax_steps.make_optimizer(tcfg)
    new, _, m = jax.jit(jax_steps.make_train_fn(jm, tcfg, opt))(jp, opt.init(jp), batch)
    out = {"grads/loss": np.asarray(loss), "train/0/loss": np.asarray(m["loss"]),
           "train/0/grad_norm": np.asarray(m["grad_norm"])}
    out.update({f"grads/{k}": np.asarray(v) for k, v in flat(grads).items()})
    out.update({f"train/params/{k}": np.asarray(v) for k, v in flat(new).items()})
    return out


def run(archs, extra_jobs: list, remat: bool = False) -> dict:
    """The world (steps of every cell, then ``extra_jobs``), with the single
    process and the reference computed while it runs (``remat`` in all
    three)."""
    prm = {arch: params(arch) for arch in archs}
    arrays = {arch: inputs(arch) for arch in archs}
    jobs = step_jobs(archs, prm, arrays, remat) + extra_jobs
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(run_ranks, ranks.run_jobs, 4, backend="gloo", device="cpu",
                            timeout_s=600, args=(jobs,))
        single_ = {arch: single(arch, prm[arch], arrays[arch], remat=remat) for arch in archs}
        ref = {arch: reference(arch, prm[arch], arrays[arch], remat) for arch in archs}
        per_rank = world.result()
    cells = [(m, a) for m in MESHES for a in archs]
    return {"cells": {cell: [r[j] for r in per_rank] for j, cell in enumerate(cells)},
            "extra": [[r[len(cells) + i] for r in per_rank] for i in range(len(extra_jobs))],
            "single": single_, "ref": ref, "params": prm, "arrays": arrays}


# ------------------------------------------------------------------ checks
def check_prefill_and_decode(runs, cell):
    got, want = runs["cells"][cell][0], runs["single"][cell[1]]
    assert got["cache_at_shardings"]
    keys = [k for k in want if k.startswith(("prefill/", "decode/"))]
    assert len(keys) > 2 * DECODE + 2
    for k in keys:
        if k.endswith("/token") or "/routes/" in k:      # tokens, MoE routes and drops
            assert np.array_equal(got["arrays"][k], want[k]), k
        else:
            within(got["arrays"][k], want[k], TOL_STEP, k)


def check_gradients(runs, cell):
    got = runs["cells"][cell][0]["arrays"]
    for want in (runs["single"][cell[1]], runs["ref"][cell[1]]):
        assert float(got["grads/loss"]) == pytest.approx(float(want["grads/loss"]), rel=TOL_LOSS)
        names = [k for k in want if k.startswith("grads/") and k != "grads/loss"]
        assert names and set(names) == {k for k in got if k.startswith("grads/")} - {"grads/loss"}
        for k in names:
            within(got[k], want[k], TOL_LEAF, k)
            assert np.abs(got[k]).max() > 0, f"{k}: zero gradient"


def check_train_step(runs, cell):
    res = runs["cells"][cell][0]
    got = res["arrays"]
    assert res["train_at_shardings"]
    for want in (runs["single"][cell[1]], runs["ref"][cell[1]]):
        for k in ("train/0/loss", "train/0/grad_norm"):
            assert float(got[k]) == pytest.approx(float(want[k]), rel=TOL_LOSS), k
        names = [k for k in want if k.startswith("train/params/")]
        assert len(names) == len(res["train_leaf_names"])
        for k in names:
            within(got[k], want[k], TOL_LEAF, k)


def check_replicated(runs, cell):
    per_rank = runs["cells"][cell]
    assert [r["rank"] for r in per_rank] == list(range(len(per_rank)))
    want = per_rank[0]["digests"]
    assert any(k.startswith("train/") for k in want) and any(k.startswith("decode/") for k in want)
    for r in per_rank[1:]:
        diff = [k for k in want if r["digests"].get(k) != want[k]]
        assert not diff, f"rank {r['rank']} differs from rank 0 in {diff[:5]}"


def check_golden(runs, arch):
    """The (2, 2) world's train steps against the reference's own sharded
    step on 8 XLA host devices (its (2, 4) mesh: the same global batch and
    the same step): loss and grad_norm 1e-5 relative, leaf norms 1e-4 x
    max(1, |norm|)."""
    gold = GOLDEN["archs"][arch]
    res = runs["cells"][((2, 2), arch)][0]
    got = res["arrays"]
    assert gold["params_sha256"] == params_sha256(runs["params"][arch])
    assert gold["inputs_sha256"] == params_sha256(runs["arrays"][arch])
    assert gold["devices"] == 8 and tuple(gold["mesh"].values()) == (2, 4)
    assert gold.get("capacity_factor") == MOE_CAPACITY.get(arch)
    for i, step in enumerate(gold["steps"]):
        assert float(got[f"train/{i}/step"]) == step["step"]
        assert float(got[f"train/{i}/loss"]) == pytest.approx(step["loss"], rel=TOL_LOSS)
        assert float(got[f"train/{i}/grad_norm"]) == pytest.approx(step["grad_norm"],
                                                                   rel=TOL_LOSS)
        norms = dict(zip(res["train_leaf_names"], got[f"train/{i}/leaf_norms"]))
        assert set(norms) == set(step["leaf_norms"])
        for name, want in step["leaf_norms"].items():
            within(norms[name], want, TOL_LEAF, f"step {i} {name}")


def params_sha256(tree) -> str:
    """The sha256 of a numpy tree's leaves by sorted name (the golden
    script's)."""
    import hashlib
    leaves = flat(tree)
    h = hashlib.sha256()
    for name in sorted(leaves):
        h.update(name.encode())
        h.update(np.ascontiguousarray(leaves[name]).tobytes())
    return h.hexdigest()


def check_specs(arch: str, smoke: bool):
    """Every resolved spec of ``arch``'s parameters, its cache (B = 8 of 27
    positions, the VLM's patches included) and its batch on (1, 4) and
    (2, 2) against the reference's ``resolve_axes``: where a dim does not
    divide its axis (whisper's 51865-word vocabulary, two heads on four
    ranks) its rules decide."""
    from jax.sharding import AbstractMesh as JaxAbstractMesh

    from repro.configs import get_config as jax_get_config
    from repro.parallel import sharding as jax_sharding
    from repro_torch.configs import get_config
    from repro_torch.parallel.sharding import AbstractMesh, resolve_axes
    cfg = (get_smoke_config if smoke else get_config)(arch)
    jcfg = (jax_get_smoke_config if smoke else jax_get_config)(arch)
    mdl = build_model(cfg, device="meta")
    jm = jax_build_model(jcfg)
    specs, in_axes = ranks.input_records(mdl, B, S)
    max_len = S + ranks.n_prefix(cfg) + DECODE
    trees = [(mdl.param_axes(), dict(named_leaves(mdl.init_params()))),
             (mdl.cache_axes(), dict(named_leaves(mdl.init_cache(B, max_len)))),
             (in_axes, specs)]
    jshapes = [dict(named_leaves(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)))),
               dict(named_leaves(jax.eval_shape(lambda: jm.init_cache(B, max_len)))), None]
    assert mdl.param_axes() == jm.param_axes() and mdl.cache_axes() == jm.cache_axes()
    n = 0
    for mesh_shape in MESHES:
        mesh = AbstractMesh(mesh_shape, ("data", "model"))
        jmesh = JaxAbstractMesh(mesh_shape, ("data", "model"))
        for (axes, shapes), js in zip(trees, jshapes):
            for name, ax in named_leaves(axes):
                shape = tuple(shapes[name].shape)
                if js is not None:
                    assert shape == tuple(js[name].shape), (arch, name)
                got = resolve_axes(ax, shape, mesh)
                want = jax_sharding.resolve_axes(ax, shape, jmesh)
                assert tuple(got) == tuple(want), (arch, mesh_shape, name, got, want)
                n += 1
    return n
