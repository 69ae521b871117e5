"""The sLSTM's training scan (``repro_torch.models.ssm.SlstmScan``) against
the reference's two: the deferred-weight-gradient custom VJP
``repro.models.ssm._slstm_scan`` and plain autodiff of its cell,
``_slstm_scan_ad``.

Pre-activations and recurrent weights drawn with numpy from a seed and fed
to all three, the loss a fixed random weighting of every step's h.  The
input-gate pre-activations are shifted up so that at the first step
log_i >= log_f: the stabilizer takes log_i, i_s = 1 and the normalizer is
exactly n = 1, the tie at which ``maximum`` would split the gradient and
the strict ``where(n > 1)`` floor does not (the test asserts the tie
occurs).  Outputs and gradients (pre, r_h) within atol = rtol = 1e-5 x
max(1, max|g|) of both references (float32 sums in another order;
measured at most 4e-7).  The prefill loop (the serving path, stepping
the same cell outside the Function) gives the training scan's values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.configs import get_smoke_config
from repro_torch.models import ssm

torch.set_num_threads(1)

B, S, NH, DH = 2, 9, 2, 8


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    pre = rng.standard_normal((S, B, 4 * NH * DH)).astype(np.float32)
    # heads' i blocks (columns dh..2dh of each head's 4dh) shifted up: a tie at t = 0
    view = pre.reshape(S, B, NH, 4 * DH)
    view[..., DH: 2 * DH] += 1.0
    r_h = (rng.standard_normal((NH, DH, 4 * DH)) * DH ** -0.5).astype(np.float32)
    w = rng.standard_normal((S, B, NH, DH)).astype(np.float32)
    return pre, r_h, w


def _check(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, float(np.abs(want).max())),
                               rtol=1e-5)


@pytest.mark.parametrize("reference", ["custom_vjp", "autodiff"])
def test_scan_matches_reference(reference):
    pre, r_h, w = _inputs()
    scan = jssm._slstm_scan if reference == "custom_vjp" else (
        lambda p, r, nh: jssm._slstm_scan_ad(p, r, nh)[0])
    jhs, vjp_fn = jax.vjp(lambda p, r: scan(p, r, NH), jnp.asarray(pre), jnp.asarray(r_h))
    jdpre, jdr = vjp_fn(jnp.asarray(w))

    tpre = torch.from_numpy(pre).transpose(0, 1).contiguous().requires_grad_(True)
    tr = torch.from_numpy(r_h).requires_grad_(True)
    hs = ssm.slstm_scan(tpre, tr, NH)                       # (B, S, nh, dh)
    (hs * torch.from_numpy(w).transpose(0, 1)).sum().backward()
    _check(hs.detach().numpy(), np.asarray(jhs).transpose(1, 0, 2, 3))
    _check(tpre.grad.numpy(), np.asarray(jdpre).transpose(1, 0, 2))
    _check(tr.grad.numpy(), jdr)


def test_first_step_ties_at_n_equal_one():
    pre, r_h, _ = _inputs()
    z = torch.zeros((B, NH, DH))
    _, n1, _, _ = ssm._cell_math(torch.from_numpy(pre[0]), z, z, z, torch.zeros((B, NH)),
                                 torch.from_numpy(r_h), NH, DH)
    assert bool((n1 == 1.0).any())


def test_serving_cell_gives_the_training_values():
    """slstm_forward's prefill (the serving loop) and train modes agree."""
    cfg = get_smoke_config("xlstm-350m").scaled(dtype="float32")
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.common import Init
    p = ssm.init_slstm(Init(torch.device("cpu"), gen), cfg)
    x = torch.randn((2, 7, cfg.d_model), generator=gen)
    with torch.no_grad():
        y_pre, _ = ssm.slstm_forward(p, cfg, x, mode="prefill")
        y_train, cache = ssm.slstm_forward(p, cfg, x, mode="train")
    assert cache is None
    torch.testing.assert_close(y_train, y_pre, atol=1e-6, rtol=1e-6)
