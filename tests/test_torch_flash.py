"""The port's attention ops against the reference's, and the CUDA flash
kernel against its plain version.

On the CPU, ``flash_attention`` runs its plain PyTorch version; it is held
to the reference's Pallas kernel in interpret mode (the TPU kernel's own
semantics: P stays float32 before P @ V) on the same numpy inputs:

* float32 at atol = rtol = 1e-5 (float32 sums in another order);
* bfloat16 at atol = rtol = 2e-2 (one rounding of the output to bfloat16,
  a bf16 step of 2^-7 relative);
* ``decode_attention`` with ``kv_len`` against the reference's at 1e-5.

The reference refuses a Pallas prefill whose length is over 128 and not a
multiple of it (``kernel.py:109-112``); the port takes any length, pinned at
300 tokens against the reference's plain ``reference_attention``.  The
kernel itself runs only on the card: the ``cuda`` tests skip here.  There
float32 inputs run the kernel's CUDA-core template (held at 2e-5) and
bfloat16 inputs its tensor-core template (held at 2e-2, one bf16 rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash.kernel import flash_attention_pallas
from repro.kernels.flash.ops import decode_attention as jax_decode_attention
from repro.kernels.flash.ref import reference_attention as jax_reference_attention
from repro_torch.kernels import build
from repro_torch.kernels.flash.kernel import _tma_ready, flash_attention_cuda
from repro_torch.kernels.flash.ops import decode_attention, flash_attention
from repro_torch.kernels.flash.ref import reference_attention

torch.set_num_threads(1)

CASES = [
    # (b, hq, hkv, sq, sk, d, dv, causal, dtype, tol)
    (2, 4, 4, 64, 64, 32, 32, True, "float32", 1e-5),     # MHA (group 1)
    (1, 4, 2, 128, 128, 32, 32, True, "float32", 1e-5),   # GQA group 2
    (1, 4, 2, 64, 64, 48, 32, True, "float32", 1e-5),     # Dv != D
    (1, 2, 1, 64, 128, 32, 32, False, "float32", 1e-5),   # non-causal, Sq < Sk
    (1, 2, 2, 64, 128, 32, 16, True, "float32", 1e-5),    # causal, Sq < Sk
    (1, 4, 2, 128, 128, 64, 64, True, "bfloat16", 2e-2),
]


def _qkv(b, hq, hkv, sq, sk, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, dv)).astype(np.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,dv,causal,dtype,tol", CASES)
def test_plain_matches_pallas_interpret(b, hq, hkv, sq, sk, d, dv, causal, dtype, tol):
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, dv)
    jdt = getattr(jnp, dtype)
    want = flash_attention_pallas(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                  causal=causal, interpret=True)
    before = dict(build.LAUNCHES)
    got = flash_attention(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype), causal=causal)
    assert build.LAUNCHES == before          # nothing launched on the CPU
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, hq, sq, dv)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("kv_len", [1, 37, 64])
def test_decode_attention_matches_reference(kv_len):
    q, k, v = _qkv(2, 4, 2, 1, 64, 32, 32, seed=kv_len)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_ragged_prefill_length_reference_refuses_port_masks():
    """A 300-token prefill: the reference's Pallas kernel raises (its block
    rule), the port masks the ragged edge and equals the plain oracle."""
    q, k, v = _qkv(1, 4, 2, 300, 300, 32, 32, seed=3)
    with pytest.raises(ValueError, match="divide the block"):
        flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                               interpret=True)
    want = jax_reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_kernel_wrapper_takes_only_cuda_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 8, 8, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)


def test_tma_ready_copies_only_what_tma_cannot_load():
    """The bf16 template's TMA loads need strides in 16-byte units: a
    (B, S, H, D) view with D = 112 passes as it is; D = 20 (40-byte rows)
    becomes a zero-padded copy whose first 20 columns are the input."""
    x = torch.randn(2, 16, 4, 112).to(torch.bfloat16).transpose(1, 2)
    assert _tma_ready(x) is x
    y = torch.randn(1, 2, 10, 20).to(torch.bfloat16)
    z = _tma_ready(y)
    assert z.shape == (1, 2, 10, 24) and all(st % 8 == 0 for st in z.stride()[:3])
    assert torch.equal(z[..., :20], y) and not z[..., 20:].any()


# ---------------------------------------------------------------------- #
# on the card only
# ---------------------------------------------------------------------- #
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,dv,causal,dtype", [
    (2, 4, 4, 200, 200, 112, 112, True, "float32"),      # ragged, D = 112
    (1, 8, 2, 130, 300, 64, 96, True, "float32"),        # GQA 4, Dv != D, Sq < Sk
    (1, 4, 1, 77, 1000, 256, 256, False, "float32"),     # largest head dims
    (2, 4, 4, 1000, 1000, 112, 112, True, "bfloat16"),
    (1, 4, 4, 200, 200, 256, 256, True, "bfloat16"),     # largest head dims, 4 boxes each
    (1, 8, 2, 300, 300, 112, 64, True, "bfloat16"),      # GQA group 4, Dv = 64 != D
    (2, 4, 4, 100, 1000, 112, 112, True, "bfloat16"),    # Sq < Sk, Sq not a multiple of 64
    # whisper-tiny's shapes (D = 64, 6 heads): the tensor-core template non-causal
    (2, 6, 6, 1500, 1500, 64, 64, False, "bfloat16"),    # encoder self-attention
    (2, 6, 6, 64, 1500, 64, 64, False, "bfloat16"),      # decoder cross-attention
    (2, 6, 6, 64, 64, 64, 64, True, "bfloat16"),         # decoder self-attention
    (1, 6, 6, 1500, 1500, 64, 64, False, "float32"),     # the f32 unit's encoder
    # minicpm3's MLA: D = nope + rope = 96 (two 64-column boxes, the second
    # half zero-filled), Dv = 64, Hq = Hkv = 40
    (1, 40, 40, 1024, 1024, 96, 64, True, "bfloat16"),
])
def test_kernel_matches_plain_on_cuda(b, hq, hkv, sq, sk, d, dv, causal, dtype):
    _need_cuda()
    q, k, v = (_torch(a, dtype).cuda() for a in _qkv(b, hq, hkv, sq, sk, d, dv, seed=sq))
    before = build.LAUNCHES["flash_fwd"]
    got = flash_attention(q, k, v, causal=causal)
    want = reference_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd"] == before + 1
    tol = 2e-5 if dtype == "float32" else 2e-2   # float32 order / one bf16 rounding
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
