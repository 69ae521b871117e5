"""Plain PyTorch versions of the Mamba-2 SSD (scalar-decay state space) scan.

Recurrence per head (state h in R^{N x P}):

    a_t = exp(-A dt_t)                      A > 0 per head
    h_t = a_t h_{t-1} + in_scale_t (B_t outer x_t)
    y_t = C_t^T h_t

``reference_ssd`` is the literal per-timestep loop; ``reference_ssd_chunked``
the chunkwise form the CUDA kernel runs (intra-chunk decay matrix plus the
carried inter-chunk state), both for one sequence (S, H, P) as in the
reference.  ``ssd_chunked`` is the batched chunkwise form: the kernel's
plain version, which ``ssd_scan`` runs on CPU tensors.  float32 throughout.
"""

from __future__ import annotations

import torch

__all__ = ["reference_ssd", "reference_ssd_chunked", "ssd_chunked"]


def reference_ssd(x, dt, A, B, C, h0=None, in_scale=None):
    """x: (S, H, P); dt: (S, H); A: (H,) (> 0); B, C: (S, G, N), H % G == 0.
    Returns y (S, H, P), h_final (H, N, P), float32."""
    s, h, p = x.shape
    g, n = B.shape[1], B.shape[2]
    x, dt = x.float(), dt.float()
    sc = dt if in_scale is None else in_scale.float()
    Bh = B.float().repeat_interleave(h // g, dim=1)                   # (S, H, N)
    Ch = C.float().repeat_interleave(h // g, dim=1)
    a = torch.exp(-A.float()[None, :] * dt)                           # (S, H)
    hstate = torch.zeros((h, n, p), dtype=torch.float32, device=x.device) if h0 is None \
        else h0.float()
    ys = []
    for t in range(s):
        hstate = a[t, :, None, None] * hstate + (sc[t, :, None] * Bh[t])[..., None] * x[t, :, None, :]
        ys.append(torch.einsum("hn,hnp->hp", Ch[t], hstate))
    return torch.stack(ys), hstate


def ssd_chunked(x, dt, A, B, C, *, chunk: int, in_scale=None, h0=None):
    """Batched chunkwise SSD: x (Bt, S, H, P); dt, in_scale (Bt, S, H);
    A (H,); B, C (Bt, S, G, N); S a multiple of ``chunk``.  Returns
    y (Bt, S, H, P) and h_final (Bt, H, N, P), both float32."""
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError("S must divide the chunk size")
    nc = s // chunk
    sc = dt if in_scale is None else in_scale
    xf = x.float().reshape(bt, nc, chunk, h, p)
    scf = sc.float().reshape(bt, nc, chunk, h)
    Bh = B.float().repeat_interleave(h // g, dim=2).reshape(bt, nc, chunk, h, n)
    Ch = C.float().repeat_interleave(h // g, dim=2).reshape(bt, nc, chunk, h, n)
    la_all = torch.cumsum((-A.float() * dt.float()).reshape(bt, nc, chunk, h), dim=2)
    lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    hstate = torch.zeros((bt, h, n, p), dtype=torch.float32, device=x.device) if h0 is None \
        else h0.float()
    ys = []
    for c in range(nc):
        la = la_all[:, c]                                             # (bt, Q, H)
        L = torch.exp(la[:, :, None, :] - la[:, None, :, :])          # (bt, Q, Q, H)
        L = L.masked_fill(~lower[None, :, :, None], 0.0)
        scores = torch.einsum("bihn,bjhn->bijh", Ch[:, c], Bh[:, c]) * L
        dx = scf[:, c, :, :, None] * xf[:, c]                        # (bt, Q, H, P)
        y_intra = torch.einsum("bijh,bjhp->bihp", scores, dx)
        y_inter = torch.exp(la)[..., None] * torch.einsum("bihn,bhnp->bihp", Ch[:, c], hstate)
        w = torch.exp(la[:, -1:, :] - la)                             # (bt, Q, H)
        hstate = (torch.exp(la[:, -1])[..., None, None] * hstate
                  + torch.einsum("bjhn,bjhp->bhnp", Bh[:, c] * w[..., None], dx))
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=1).reshape(bt, s, h, p), hstate


def reference_ssd_chunked(x, dt, A, B, C, h0=None, chunk: int = 64, in_scale=None):
    """Chunkwise SSD of one sequence: x (S, H, P), shapes as in
    :func:`reference_ssd`."""
    y, hf = ssd_chunked(x[None], dt[None], A, B[None], C[None], chunk=chunk,
                        in_scale=None if in_scale is None else in_scale[None],
                        h0=None if h0 is None else h0[None])
    return y[0], hf[0]
