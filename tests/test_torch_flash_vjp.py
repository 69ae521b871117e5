"""The flash backward (``repro_torch.kernels.flash.vjp``) against the
reference's custom VJP ``repro.kernels.flash.vjp.flash_mha_vjp``.

On the CPU the Function's forward is the plain version with its lse, its
backward the plain mirror of the reference's ``_vjp_bwd``; the reference
runs its chunked forward (``fwd_impl=None``).  Inputs drawn with numpy from
a seed, fed to both; each case checks the output, the lse (the reference's
``_vjp_fwd`` residual) and dq, dk, dv of one cotangent:

* float32: atol = rtol = 1e-5 (float32 sums in another order; measured
  at most 4e-7 x (1 + |x|));
* bfloat16: output and gradients within atol = rtol = 2e-2 (both round the
  products' operands and the outputs to bfloat16, at other places; one
  bfloat16 step is 2^-8 to 2^-7 relative; measured at most 7.4e-3 x
  (1 + |x|)), the float32 lse within 1e-4 (measured 1.2e-7).

Cases: causal and not, GQA (Hq = 4 x Hkv), Sq < Sk (the queries at the end
of the keys), Dv != D, Sk not a multiple of the key block (a ragged last
block), float32 and bfloat16.  Also: ``ops.flash_attention`` routes a
grad-requiring call through the Function on the CPU (key blocks of
``ops.BLOCK_K`` = 512, as on the card), and a ``cuda`` test holds the kernel's
lse and the Function's gradients to the plain path on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash import vjp as jvjp
from repro_torch.kernels import build
from repro_torch.kernels.flash import ops, vjp
from repro_torch.kernels.flash.ref import attention_with_lse, reference_attention

torch.set_num_threads(1)

CASES = {
    # name: (B, Hq, Hkv, Sq, Sk, D, Dv, causal, block_k)
    "causal": (2, 2, 2, 16, 16, 8, 8, True, 8),
    "bidirectional": (2, 2, 2, 16, 16, 8, 8, False, 8),
    "gqa": (1, 4, 1, 12, 12, 8, 8, True, 8),
    "sq_lt_sk": (1, 2, 2, 6, 20, 8, 8, True, 8),
    "dv_ne_d": (2, 2, 1, 10, 10, 8, 4, True, 4),
    "ragged_block": (1, 2, 2, 13, 13, 8, 8, True, 5),
}
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
LSE_TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=1e-4, rtol=1e-4)}


def _inputs(b, hq, hkv, sq, sk, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, dv)).astype(np.float32),
            rng.standard_normal((b, hq, sq, dv)).astype(np.float32))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_function_matches_reference_vjp(case, dtype):
    b, hq, hkv, sq, sk, d, dv, causal, block = CASES[case]
    q, k, v, g = _inputs(b, hq, hkv, sq, sk, d, dv)
    scale = d ** -0.5
    jd = getattr(jnp, dtype)
    jq, jk, jv, jg = (jnp.asarray(a, jd) for a in (q, k, v, g))
    jout, vjp_fn = jax.vjp(lambda a, b_, c: jvjp.flash_mha_vjp(a, b_, c, causal, scale, block,
                                                                None), jq, jk, jv)
    jdq, jdk, jdv = vjp_fn(jg)
    _, (_, _, _, _, jlse) = jvjp._vjp_fwd(jq, jk, jv, causal, scale, block, None)

    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(td).requires_grad_(True) for a in (q, k, v))
    out = vjp.flash_mha(tq, tk, tv, causal, scale, block)
    out.backward(torch.from_numpy(g).to(td))
    _, lse = vjp.forward_with_lse(tq.detach(), tk.detach(), tv.detach(), causal, scale)

    assert out.dtype == td and tq.grad.dtype == td and lse.dtype == torch.float32
    np.testing.assert_allclose(_f32(out), _f32(jout), **TOL[dtype], err_msg="out")
    np.testing.assert_allclose(_f32(lse), _f32(jlse), **LSE_TOL[dtype], err_msg="lse")
    for name, got, want in (("dq", tq.grad, jdq), ("dk", tk.grad, jdk), ("dv", tv.grad, jdv)):
        assert tuple(got.shape) == tuple(want.shape), name
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype], err_msg=name)


def test_plain_lse_is_the_log_normaliser():
    """attention_with_lse's output is reference_attention's, its lse the
    row logsumexp of the masked scaled scores."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 5, 9, 4, 4, seed=1))
    out, lse = attention_with_lse(q, k, v, causal=True, scale=0.5)
    torch.testing.assert_close(out, reference_attention(q, k, v, causal=True, scale=0.5))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.5
    s = s.masked_fill(torch.arange(9)[None, :] > torch.arange(5)[:, None] + 4, float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1))


def test_ops_route_grad_calls_through_the_function():
    """``ops.flash_attention`` on grad-requiring CPU inputs builds the
    Function's graph (key blocks of 512, as on the card); with
    no input requiring grad, or under no_grad, it runs the plain version."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 8, 8, 4, 4))
    leaf = q.clone().requires_grad_(True)
    out = ops.flash_attention(leaf, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(g)
    q2 = q.clone().requires_grad_(True)
    reference_attention(q2, k, v, causal=True).backward(g)
    torch.testing.assert_close(leaf.grad, q2.grad, atol=1e-5, rtol=1e-5)
    assert ops.flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert ops.flash_attention(leaf, k, v).grad_fn is None
    assert ops.BLOCK_K == 512


@pytest.mark.cuda
def test_kernel_lse_and_gradients_on_cuda():
    """On the card: B3's lse (both templates) against the plain lse, the
    Function's gradients against plain autograd, and the wrapper's refusal
    of grad-requiring inputs outside the Function."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    from repro_torch.kernels.flash.kernel import flash_attention_cuda
    q, k, v, g = _inputs(2, 8, 2, 100, 130, 64, 48)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        tq, tk, tv = (torch.from_numpy(a).to("cuda", dtype) for a in (q, k, v))
        before = build.LAUNCHES["flash_fwd"]
        out, lse = flash_attention_cuda(tq, tk, tv, causal=True, scale=0.125, return_lse=True)
        assert build.LAUNCHES["flash_fwd"] == before + 1
        want_out, want_lse = attention_with_lse(tq, tk, tv, causal=True, scale=0.125)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(out.float(), want_out.float(), atol=tol, rtol=tol)
        leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        with pytest.raises(RuntimeError, match="no gradient"):
            flash_attention_cuda(*leaves, causal=True)
        ops.flash_attention(*leaves, causal=True, scale=0.125).backward(
            torch.from_numpy(g).to("cuda", dtype))
        plain = [t.float().clone().requires_grad_(True) for t in (tq, tk, tv)]
        reference_attention(*plain, causal=True, scale=0.125).backward(
            torch.from_numpy(g).to("cuda"))
        for got, want in zip(leaves, plain):
            torch.testing.assert_close(got.grad.float(), want.grad, atol=tol, rtol=tol)
