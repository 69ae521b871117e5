"""The port's bfloat16 LM loss and gradients against the JAX package's
(the float32 cases and the train step are ``tests/test_torch_lm_train.py``,
whose helpers this file uses).

The three ported SMOKE architectures in bfloat16, the reference built with
``remat=False, attn_impl="chunked", ssd_impl="chunked"`` and its own
weights carried across.  The two frameworks round to bfloat16 at other
places in every product, norm and gate, so the port's bfloat16 gradients
are held to the float32 gradients of the same weights (the reference's,
upcast), each leaf on its own: ||g_port - g_f32|| <= tol x ||g_f32||, with
``TOL_REL`` per architecture at about twice the largest error measured
over its leaves.  No leaf is left out.  xlstm's smoke model amplifies
bfloat16 rounding through its exponential gates on every leaf alike: the
port's error reaches 0.156 there (``blocks/u0/mlstm/norm_w``) and the
reference's own bfloat16 gradients 0.546; zamba2's largest is 0.067
(``blocks/u1/mamba/dt_bias``, the reference's own 0.036), whisper's 0.021
(``encoder/attn/wk``, the reference's own 0.020).  A gradient that is half
the right one (error 0.5) fails on every leaf.  The loss within 2e-3
relative of the reference's bfloat16 loss (measured at most 2.0e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm_train import ARCHS, _batch, _losses_and_grads, _named, _pair

torch.set_num_threads(1)

TOL_REL = {"zamba2-7b": 0.15, "whisper-tiny": 0.05, "xlstm-350m": 0.3}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_bf16(arch):
    jm16, jp16, model, params = _pair(arch, "bfloat16")
    batch = _batch(model.cfg)
    jl, _, loss, grads = _losses_and_grads(jm16, jp16, model, params, batch)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp16)
    jm32, _, _, _ = _pair(arch, "float32", jp32)
    truth = {k: np.asarray(v, np.float32) for k, v in _named(jax.grad(jm32.loss)(
        jp32, {k: jnp.asarray(v) for k, v in batch.items()})).items()}
    assert loss == pytest.approx(jl, rel=2e-3)
    assert set(grads) == set(truth)
    for name, want in truth.items():
        norm = float(np.linalg.norm(want))
        assert norm > 0.0, name
        err = float(np.linalg.norm(grads[name] - want)) / norm
        assert err <= TOL_REL[arch], (name, err)
