"""Plain PyTorch attention: the textbook O(S^2) computation.

The kernel's plain version: ``flash_attention`` runs it on CPU tensors, and
the tests and ``chip_smoke.py`` hold the CUDA kernel to it.  Scores,
softmax and the P @ V product are float32 whatever the input dtype (as in
the reference's Pallas kernel); the output has q's dtype.
"""

from __future__ import annotations

import torch

__all__ = ["reference_attention", "attention_with_lse", "expand_kv"]


def expand_kv(k: torch.Tensor, hq: int) -> torch.Tensor:
    """(B, Hkv, S, D) -> (B, Hq, S, D): q head h reads kv head h // group."""
    hkv = k.shape[1]
    return k if hkv == hq else torch.repeat_interleave(k, hq // hkv, dim=1)


def reference_attention(q, k, v, causal: bool = True, scale: float | None = None,
                        kv_len: int | None = None):
    """q: (B, Hq, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv).

    Queries sit at the end of the keys (prefill: Sq == Sk).  ``kv_len``
    masks keys at index >= kv_len (a decode against a longer cache).
    """
    sq, d = q.shape[2], q.shape[3]
    sk = k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    k = expand_kv(k, q.shape[1])
    v = expand_kv(v, q.shape[1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    ki = torch.arange(sk, device=q.device)
    if causal and sq > 1:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        s = s.masked_fill(ki[None, :] > qi, float("-inf"))
    if kv_len is not None:
        s = s.masked_fill(ki >= kv_len, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_with_lse(q, k, v, causal: bool = True, scale: float | None = None):
    """(out, lse): :func:`reference_attention` and each row's log-sum-exp
    of the scaled, masked scores, (B, Hq, Sq) float32 — the forward of the
    flash backward (``vjp.py``), whose plain version this is."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), expand_kv(k, q.shape[1]).float()) * scale
    if causal and sq > 1:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        s = s.masked_fill(torch.arange(sk, device=q.device)[None, :] > qi, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, expand_kv(v, q.shape[1]).float())
    return out.to(q.dtype), lse
