"""The port's pipeline runner (``repro_torch.parallel.pipeline``) against the
reference's ``repro.parallel.pipeline``, on the CPU.

The reference test's case (``tests/test_distributed.py``): 6-layer
internlm2-1.8b SMOKE cut ``[[0, 1], [2], [3, 4], [5]]``, ``n_micro = 4``,
x (4, 2, 8, d).  The reference's ``init_params`` is carried across with
``params_from_numpy``, and the port's GPipe ``forward`` (four stages on
``"cpu"``) is held to the reference's ``sequential_forward``, which runs in
process without a mesh:

* float32 within 1e-5 (sums in another order);
* bfloat16 within the zoo's cross-framework bound, atol 0.12 + rtol 2e-2
  (``tests/test_torch_zoo_archs.py``: the two frameworks round to bf16 at
  other places; one bf16 step at |y| ~ 10 is 0.0625), and the port's
  pipelined forward within the reference's own pipelined-vs-sequential
  bound, 1e-3, of the port's sequential one.

The pipelined gradient (remat on and off) equals the sequential gradient,
and the runner refuses what the reference refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.parallel.pipeline import PipelineRunner as JaxPipelineRunner
from repro_torch.configs import get_smoke_config
from repro_torch.models.common import KeyStream
from repro_torch.optim import tree_map
from repro_torch.parallel import PipelineRunner

torch.set_num_threads(1)

STAGES = [[0, 1], [2], [3, 4], [5]]
N_MICRO = 4
CPU4 = ["cpu"] * 4
TOL = {"float32": {"atol": 1e-5, "rtol": 0.0}, "bfloat16": {"atol": 0.12, "rtol": 2e-2}}
TOL_PIPE = 1e-3        # the reference's pipelined-vs-sequential bound


def _cfgs(dtype: str):
    return (jax_smoke_config("internlm2-1.8b").scaled(n_layers=6, dtype=dtype),
            get_smoke_config("internlm2-1.8b").scaled(n_layers=6, dtype=dtype))


def _x(d: int) -> np.ndarray:
    return np.random.default_rng(1).normal(size=(N_MICRO, 2, 8, d)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference_sequential(dtype):
    jcfg, cfg = _cfgs(dtype)
    jr = JaxPipelineRunner(jcfg, None, STAGES, n_micro=N_MICRO, remat=False)
    jp = jr.init_params(jax.random.PRNGKey(0))
    x = _x(cfg.d_model)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    want = np.asarray(jr.sequential_forward(jp, jx).astype(jnp.float32))

    runner = PipelineRunner(cfg, STAGES, n_micro=N_MICRO, remat=False, devices=CPU4)
    params = runner.params_from_numpy(jax.tree.map(np.asarray, jp))
    tx = torch.from_numpy(x).to(torch.float32 if dtype == "float32" else torch.bfloat16)
    with torch.no_grad():
        got = runner.forward(params, tx)
        seq = runner.sequential_forward(params, tx)
    assert got.shape == (N_MICRO, 2, 8, cfg.d_model) and got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    assert float((got.float() - seq.float()).abs().max()) <= TOL_PIPE


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _grads(runner, params, x, pipelined: bool):
    params = {"blocks": tree_map(lambda a: a.detach().clone().requires_grad_(True),
                                 params["blocks"]), "valid": params["valid"]}
    x = x.clone().requires_grad_(True)
    fn = runner.forward if pipelined else runner.sequential_forward
    y = fn(params, x)
    (y.float() ** 2).mean().backward()
    return y.detach(), x.grad, {k: v.grad for k, v in _named(params["blocks"])}


@pytest.mark.parametrize("remat", [True, False])
def test_pipelined_gradient_equals_sequential(remat):
    _, cfg = _cfgs("float32")
    runner = PipelineRunner(cfg, STAGES, n_micro=N_MICRO, remat=remat, devices=CPU4)
    params = runner.init_params(KeyStream(3))
    x = torch.from_numpy(_x(cfg.d_model))
    y_p, gx_p, g_p = _grads(runner, params, x, True)
    y_s, gx_s, g_s = _grads(runner, params, x, False)
    assert torch.equal(y_p, y_s)
    assert torch.allclose(gx_p, gx_s, rtol=0, atol=1e-7)
    assert set(g_p) == set(g_s) and all(g is not None for g in g_p.values())
    for k in g_p:
        scale = max(1.0, float(g_s[k].abs().max()))
        assert torch.allclose(g_p[k], g_s[k], rtol=0, atol=1e-7 * scale), k
    # the stages' padded slots exist (l_max = 2) but receive no gradient
    ln1 = g_p["ln1"]
    assert ln1.shape[:2] == (4, 2) and not ln1[1, 1].any() and not ln1[3, 1].any()
    assert ln1[0, 1].abs().sum() > 0


def test_refusals_and_params():
    jcfg, cfg = _cfgs("float32")
    hybrid = get_smoke_config("zamba2-7b")
    with pytest.raises(NotImplementedError, match="uniform-attn"):
        PipelineRunner(hybrid, [[0, 1, 2], [3, 4, 5]], n_micro=2, devices=["cpu"] * 2)
    for bad in ([[0, 2], [1], [3, 4], [5]], [[0, 1], [2], [3]]):
        with pytest.raises(ValueError, match="contiguous cover"):
            PipelineRunner(cfg, bad, n_micro=2, devices=["cpu"] * len(bad))
        with pytest.raises(ValueError, match="contiguous cover"):
            JaxPipelineRunner(jcfg, None, bad, n_micro=2)
    with pytest.raises(ValueError, match="devices"):
        PipelineRunner(cfg, STAGES, n_micro=2, devices=["cpu"] * 3)
    runner = PipelineRunner(cfg, STAGES, n_micro=N_MICRO, devices=CPU4)
    assert runner.ticks == 7 and runner.bubble_fraction == pytest.approx(3 / 7)
    params = runner.init_params(KeyStream(0))
    assert params["valid"].tolist() == [[True, True], [True, False], [True, True],
                                        [True, False]]
    assert params["blocks"]["attn"]["wq"].shape[:2] == (4, 2)
    jp = jax.tree.map(np.asarray, JaxPipelineRunner(jcfg, None, STAGES, n_micro=N_MICRO)
                      .init_params(jax.random.PRNGKey(0)))
    jp["valid"] = np.ones_like(jp["valid"])
    with pytest.raises(ValueError, match="valid mask"):
        runner.params_from_numpy(jp)
    with pytest.raises(ValueError, match="microbatches"):
        runner.forward(params, torch.zeros((2, 2, 8, cfg.d_model)))


def test_pipeline_demo_reduced_execution(tmp_path, capsys):
    """``python -m repro_torch.pipeline_demo``'s default run on the CPU: the
    four partitions of the full config, then the reduced cut pipelined
    equal to sequential."""
    from repro_torch import pipeline_demo
    assert pipeline_demo.main(["--arch", "internlm2-1.8b", "--device", "cpu",
                               "--agent", str(tmp_path / "none")]) == 0
    out = capsys.readouterr().out
    for method in pipeline_demo.METHODS:
        assert f"{method:9s} bottleneck=" in out
    assert "pipelined vs sequential max |err| = 0.00e+00  (OK)" in out
