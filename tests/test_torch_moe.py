"""The port's MoE layer (``models.mlp.moe_forward``) against the
reference's on the same weights (the reference's ``init_moe`` carried across
as numpy) and the same float32 inputs, B = 2 x 16 tokens:

* the routes: the port's ``moe_route`` top-k experts equal the reference's
  ``top_k`` of its softmax exactly, and every token's k-th/(k+1)-th gate
  margin exceeds 1e-6, so that a flip would be a real difference;
* the output within atol = rtol = 1e-5 (float32 sums in another order;
  measured at most 4.8e-7);

for the SMOKE config of qwen3-moe (8 experts, top 2), a capacity factor so
small that slots are dropped (the test asserts that some are: which ones
depends on the token-major cumsum order), and one shared expert.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import mlp as jax_mlp
from repro_torch.configs import MoEConfig, get_smoke_config
from repro_torch.models import mlp

torch.set_num_threads(1)

B, S = 2, 16


def _case(cf=None, shared=0):
    jcfg = jax_get_smoke_config("qwen3-moe-235b-a22b").scaled(dtype="float32")
    cfg = get_smoke_config("qwen3-moe-235b-a22b").scaled(dtype="float32")
    if shared:
        m = dict(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=shared)
        jcfg, cfg = jcfg.scaled(moe=JaxMoEConfig(**m)), cfg.scaled(moe=MoEConfig(**m))
    jp = jax_mlp.init_moe(jax.random.PRNGKey(0), jcfg)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, p, x


def _dropped(top_e, e, capacity):
    counts = np.bincount(top_e.reshape(-1), minlength=e)
    return int(np.maximum(counts - capacity, 0).sum())


@pytest.mark.parametrize("cf,shared", [(None, 0), (0.5, 0), (None, 1)],
                         ids=["smoke", "dropped", "shared"])
def test_moe_forward_matches_jax(cf, shared):
    jcfg, cfg, jp, p, x = _case(cf, shared)
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    xf = x.reshape(B * S, -1)
    gates, _, top_e = mlp.moe_route(p, cfg, torch.from_numpy(xf))
    jgates = jax.nn.softmax(jnp.asarray(xf) @ jp["router"], axis=-1)
    _, jtop_e = jax.lax.top_k(jgates, k)
    assert np.array_equal(top_e.numpy(), np.asarray(jtop_e))
    srt = -np.sort(-np.asarray(jgates), axis=-1)
    assert (srt[:, k - 1] - srt[:, k]).min() > 1e-6
    capacity = max(int(B * S * k * (cf or cfg.moe.capacity_factor) / e), 1)
    if cf is not None:
        assert _dropped(top_e.numpy(), e, capacity) > 0
    want = jax_mlp.moe_forward(jp, jcfg, jnp.asarray(x), capacity_factor=cf)
    got = mlp.moe_forward(p, cfg, torch.from_numpy(x), capacity_factor=cf)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert ("shared" in p) == bool(shared)


def test_dropped_slots_are_the_later_ones_in_token_order():
    """With capacity 1 each expert keeps only its first slot in the
    token-major order: the output of a token whose every slot came later
    than another token's on the same experts is zero."""
    jcfg, cfg, jp, p, x = _case()
    x1 = np.concatenate([x[:1, :1], x[:1, :1]], axis=1)          # one token, twice
    got = mlp.moe_forward(p, cfg, torch.from_numpy(x1), capacity_factor=0.01)
    want = jax_mlp.moe_forward(jp, jcfg, jnp.asarray(x1), capacity_factor=0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert got[0, 0].abs().max() > 0 and not got[0, 1].any()
