#!/usr/bin/env python
"""Write the golden file of the reference's own sharded train step.

    JAX_PLATFORMS=cpu python scripts/make_sharded_golden.py \
        [--out tests/golden/torch_sharded_steps.json]

The JAX package's ``repro.launch.steps.make_train_step`` on
``small_test_mesh(2, 4)`` over 8 XLA host devices (this process sets
``--xla_force_host_platform_device_count=8`` before JAX starts, as
``tests/test_distributed.py`` does for its subprocesses), jitted with its
in- and out-shardings: SMOKE configs in float32, ``TrainConfig(
microbatches=2)``, two steps on one batch of 8 x 16 tokens from
``numpy.random.default_rng(0)``.  The parameters are the port's
``Model.init_params(seed=0, host=True)`` (threefry on the host, in numpy:
the same bits on every machine), carried into JAX as arrays; their sha256
is recorded beside each step's loss, grad_norm and parameter leaf norms.

The top level holds internlm2-1.8b; ``"archs"`` holds xlstm-350m,
llava-next-mistral-7b, minicpm3-4b and qwen3-moe-235b-a22b, whose batch
adds the model's other inputs (``repro_torch.launch.ranks.model_inputs``:
the VLM's patches, N(0, 1) from the same seed, in bfloat16 as the
reference's ``input_specs`` give them; their sha256 beside the
parameters').  minicpm3-4b and qwen3-moe are built with the reference's
default ``remat=True``, as their rank tests train, and qwen3-moe at the
capacity factor of those tests (``CAPACITY``, recorded), which drops
slots.

``tests/test_torch_sharded_exec.py`` holds the port's (2, 4) world of gloo
ranks to the top level, ``tests/test_torch_sharded_exec_ssm.py``,
``_vlm.py`` and ``_mla_moe.py`` their (2, 2) worlds (the same global batch)
to ``"archs"``.  The file is rewritten only by this script (~60 s).
"""

from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "tests" / "golden" / "torch_sharded_steps.json"
ARCH = "internlm2-1.8b"
ARCHS = ("xlstm-350m", "llava-next-mistral-7b", "minicpm3-4b", "qwen3-moe-235b-a22b")
REMAT = ("minicpm3-4b", "qwen3-moe-235b-a22b")
CAPACITY = {"qwen3-moe-235b-a22b": 1.0}
MESH = (2, 4)
BATCH, SEQ, STEPS, MICROBATCHES = 8, 16, 2, 2


def _port_model(arch: str):
    from repro_torch.launch import ranks
    from repro_torch.models.model import build_model
    return build_model(ranks.config_of(arch, capacity_factor=CAPACITY.get(arch)), device="cpu")


def port_params(arch: str = ARCH) -> dict:
    """The port's host-drawn SMOKE float32 parameters, as numpy (name ->
    array, keys sorted at each level)."""
    from repro_torch.launch import named_leaves
    model = _port_model(arch)
    return {name: t.numpy() for name, t in named_leaves(model.init_params(seed=0, host=True))}


def port_inputs(arch: str) -> dict:
    """The batch as numpy: the tokens and the model's other inputs."""
    from repro_torch.launch import ranks
    return ranks.model_inputs(_port_model(arch), tokens(), seed=0)


def params_sha256(flat: dict) -> str:
    h = hashlib.sha256()
    for name in sorted(flat):
        h.update(name.encode())
        h.update(np.ascontiguousarray(flat[name]).tobytes())
    return h.hexdigest()


def tokens() -> np.ndarray:
    return np.random.default_rng(0).integers(0, 256, (BATCH, SEQ)).astype(np.int32)


def _path_name(path) -> str:
    return "/".join(k.key for k in path)


def _as_reference_tree(flat: dict, shapes):
    """``flat`` as JAX arrays in the structure of the reference's
    ``init_params`` (``shapes``: its ``eval_shape``), each leaf checked."""
    import jax
    import jax.numpy as jnp

    def leaf(path, spec):
        a = flat[_path_name(path)]
        assert a.shape == spec.shape and a.dtype == spec.dtype, (_path_name(path), a.shape)
        return jnp.asarray(a)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def reference_steps(arch: str, flat: dict, arrays: dict):
    """The reference's two sharded steps of ``arch`` from ``flat`` on the
    batch ``arrays`` (remat for :data:`REMAT`, an MoE at its
    :data:`CAPACITY`): (per-step records, the trained parameters)."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro.configs import TrainConfig, get_smoke_config
    from repro.launch import steps
    from repro.launch.mesh import small_test_mesh
    from repro.models.model import build_model
    from repro.utils.jaxcompat import set_mesh

    cfg = get_smoke_config(arch).scaled(dtype="float32")
    if arch in CAPACITY:
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=CAPACITY[arch]))
    mesh = small_test_mesh(data=MESH[0], model=MESH[1])
    model = build_model(cfg, remat=arch in REMAT)
    batch = {k: jnp.asarray(v) if k == "tokens" else jnp.asarray(v, jnp.bfloat16)
             for k, v in arrays.items()}
    specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()}
    axes = {k: ("batch", None) if k == "tokens" else ("batch", None, None) for k in batch}
    out_steps = []
    with set_mesh(mesh):
        jfn, (p_sh, o_sh, b_sh), opt = steps.make_train_step(
            model, mesh, TrainConfig(microbatches=MICROBATCHES), specs, axes)
        shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
        params = jax.device_put(_as_reference_tree(flat, shapes), p_sh)
        opt_state = jax.jit(opt.init, out_shardings=o_sh)(params)
        batch = jax.device_put(batch, b_sh)
        for _ in range(STEPS):
            params, opt_state, m = jfn(params, opt_state, batch)
            leaves = jax.tree_util.tree_flatten_with_path(params)[0]
            norms = {_path_name(path): float(np.linalg.norm(
                np.asarray(v, np.float64).ravel())) for path, v in leaves}
            out_steps.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                              "step": int(m["step"]), "leaf_norms": norms})
    return out_steps, params


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()

    import jax

    flat = port_params()
    out_steps, params = reference_steps(ARCH, flat, {"tokens": tokens()})
    wq = params["blocks"]["u0"]["attn"]["wq"]
    rec = {"jax": jax.__version__, "devices": jax.device_count(), "arch": ARCH,
           "config": "SMOKE, dtype float32", "mesh": {"data": MESH[0], "model": MESH[1]},
           "train_config": {"microbatches": MICROBATCHES},
           "tokens": f"numpy.random.default_rng(0).integers(0, 256, ({BATCH}, {SEQ})), int32",
           "params": "repro_torch Model.init_params(seed=0, host=True)",
           "params_sha256": params_sha256(flat),
           "wq_shards": len({d.id for d in wq.sharding.device_set}),
           "steps": out_steps, "archs": {}}
    for arch in ARCHS:
        flat = port_params(arch)
        arrays = port_inputs(arch)
        rec["archs"][arch] = {
            "devices": jax.device_count(), "mesh": {"data": MESH[0], "model": MESH[1]},
            "inputs": "repro_torch.launch.ranks.model_inputs(model, tokens, seed=0)",
            "params_sha256": params_sha256(flat), "inputs_sha256": params_sha256(arrays),
            "remat": arch in REMAT, "capacity_factor": CAPACITY.get(arch),
            "steps": reference_steps(arch, flat, arrays)[0]}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rec, indent=1) + "\n")
    print(f"wrote {args.out}: losses {[s['loss'] for s in out_steps]}; "
          + "; ".join(f"{a} {[s['loss'] for s in rec['archs'][a]['steps']]}" for a in ARCHS))


if __name__ == "__main__":
    main()
