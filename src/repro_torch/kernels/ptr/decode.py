"""Whole-decode pointer kernel (``csrc/ptr_decode.cu``) and its plain version.

The counterpart of the reference's ``repro.kernels.ptr.decode``: the whole
greedy or sampled pointing decode of a padded batch in one launch.
:func:`decode_batch` launches the kernel for CUDA tensors and runs
:func:`decode_batch_reference` — the plain PyTorch decode loop of
:class:`repro_torch.core.ptrnet.PointerNet` — for CPU tensors.

The kernel has three templates, chosen by shape and batch
(:func:`decode_template`): ``ptr_decode_cluster`` runs a graph on a cluster
of four blocks that keep the decoder's gate weights in their shared memory
(hidden widths up to 128 at the release's buckets); ``ptr_decode_wide_f32``
on a cluster of 16 blocks that keep the gate weights and the query weights
(hidden widths above 128, e.g. the default 256, for batches of a few
waves); ``ptr_decode_block`` on one block that reads them from L2 every step
(any other width whose state fits).  Each template counts its own launches
in ``LAUNCHES``.

``bf16=True`` is the reference's ``decode_batch(bf16=True)``: the templates'
bf16 storage twins (``ptr_decode_cluster_bf16``, ``ptr_decode_wide_bf16``,
``ptr_decode_block_bf16``) take ``C``, ``C @ W_ref`` of both heads (rounded
from the float32 products), ``emb``, ``dec0`` and every decoder weight but
the bias in bfloat16, and sum in float32.  The plain version rounds the same
operands and decodes in float32.  Its orders are the reference's bf16
orders, which may differ from the float32 ones.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import build
from .kernel import MAX_SMEM_BYTES, THREADS, _WARPS, refuse_grad
from .ref import precompute_refs, reference_pointer_step

__all__ = ["decode_batch", "decode_batch_reference", "decode_kernel_supported",
           "decode_smem_bytes", "decode_template", "launch", "step_uniforms", "stored_operands",
           "wide_clusters", "TEMPLATES", "ARGTYPES", "WIDE_MAX_WAVES"]

#: blocks a graph of the cluster template runs on (PTR_CLUSTER in ptr_decode.cu)
CLUSTER = 4
#: blocks a graph of the wide template runs on (PTR_WIDE), and the widths it
#: takes: above the cluster template's, at most one unit a thread of a block
WIDE = 16
WIDE_MIN_HIDDEN = 129
#: the most waves of wide clusters a launch may take (PTR_WIDE_MAX_WAVES)
WIDE_MAX_WAVES = 2
#: the kernel's templates, by the value its launcher reports
TEMPLATES = {1: "ptr_decode_cluster", 0: "ptr_decode_block",
             3: "ptr_decode_cluster_bf16", 2: "ptr_decode_block_bf16",
             4: "ptr_decode_wide_f32", 5: "ptr_decode_wide_bf16"}


def _names(bf16: bool) -> tuple[str, str, str]:
    """The cluster, wide and block templates of a storage type."""
    return TEMPLATES[2 * bf16 + 1], TEMPLATES[4 + bf16], TEMPLATES[2 * bf16]


def decode_smem_bytes(n: int, hidden: int, max_deg: int, template: str) -> int:
    """Dynamic shared memory of one block of ``template``, any of
    :data:`TEMPLATES` (mirrors ``ptr_decode_{block,cluster}_smem_bytes``):
    the per-graph state all keep (decoder input, query and score vectors,
    per-node scores, lists, flags and parent indices), plus h, c, gates and
    bias for the block template.  A cluster template of K blocks a graph (4,
    or 16 for the wide one) adds the block's Wx and Wh columns (2 hidden x
    4 hidden/K elements of the storage type: 4 bytes, 2 for bf16), for the
    wide one also its Wqg and Wqp columns (2 hidden x hidden/K), then h by
    step parity and the bias of its units in float32."""
    state = (4 * (6 * hidden + THREADS + _WARPS + 2 * n)
             + 4 * (n + _WARPS + n * max_deg + 1) + n)
    if template in (TEMPLATES[0], TEMPLATES[2]):
        return 4 * 10 * hidden + state
    if template not in TEMPLATES.values():
        raise ValueError(f"unknown template {template!r}")
    elem = 2 if template.endswith("_bf16") else 4
    wide = template in (TEMPLATES[4], TEMPLATES[5])
    hq = hidden // (WIDE if wide else CLUSTER)
    cols = 4 * hq + (hq if wide else 0)
    return elem * 2 * hidden * cols + 4 * (2 * hidden + 4 * hq) + state


def _cluster_takes(size: int, bucket_n: int, hidden: int, max_deg: int, name: str) -> bool:
    """``ptr_cluster_takes``: the shape gate of the cluster template of
    ``size`` blocks a graph (the wide one's batch rule aside)."""
    width = (WIDE_MIN_HIDDEN <= hidden <= THREADS if size == WIDE
             else 0 < hidden and THREADS % hidden == 0)
    return (width and hidden % size == 0 and hidden % 4 == 0
            and decode_smem_bytes(bucket_n, hidden, max_deg, name) <= MAX_SMEM_BYTES)


def decode_template(bucket_n: int, hidden: int, max_deg: int = 6, bf16: bool = False, *,
                    batch: int = 1, clusters: int | None = None) -> str:
    """The template the launcher runs for ``batch`` graphs of a (bucket_n,
    hidden, max_deg) batch in the storage type (``bf16``), on a card that
    holds ``clusters`` clusters of the wide template at once at this shape
    (None: ask the current card, :func:`wide_clusters`, which builds the
    kernel's library; asked only where the wide template takes the shape).
    Every Hopper card holds a four-block cluster.  In this order:

    * the cluster template when hidden splits four ways and divides the
      512-thread block and its shared memory fits 227 KB (hidden <= 128);
    * the wide template when 128 < hidden <= 512, hidden splits 16 ways, its
      shared memory fits, and the batch takes at most ``WIDE_MAX_WAVES``
      waves of ``clusters``;
    * else the block template when its own shared memory fits (any width).

    The waves rule comes from the A/B in turns of ``scripts/ptr_decode_phases.py
    --wide`` at hidden 256 on an H100 SXM (700 W; PERF.md §6): the
    block template runs up to 132 graphs in one wave at a time that hardly
    grows with the batch (bucket 1024: 24.76 ms at B = 1, 25.64 at B = 16;
    bucket 32: 0.95 ms at B = 16, 1.20 at B = 128), while the wide
    template's grows with its waves of 7 clusters (14 for bf16 at bucket
    32): bucket 1024 one wave 9.84 ms, two 14.91, three 26.29 (slower than
    the block's 25.63); bucket 32, float32, two waves (B = 8, 14) 0.72 and
    0.73 ms against 0.93 and 0.94, three 1.09 against 0.94; bf16 one wave
    0.43 against 0.99, two 0.79 against 1.01, three 1.21 against 1.03.  So
    two waves at most.  The four-block cluster template has no waves rule
    (PERF.md §6 says why).  Raises ``ValueError`` when no template takes the
    shape."""
    cluster, wide, block = _names(bf16)
    if _cluster_takes(CLUSTER, bucket_n, hidden, max_deg, cluster):
        return cluster
    if _cluster_takes(WIDE, bucket_n, hidden, max_deg, wide):
        if clusters is None:
            clusters = wide_clusters(bucket_n, hidden, max_deg, bf16)
        if clusters > 0 and -(-batch // clusters) <= WIDE_MAX_WAVES:
            return wide
    if hidden > 0 and decode_smem_bytes(bucket_n, hidden, max_deg, block) <= MAX_SMEM_BYTES:
        return block
    raise ValueError(f"ptr_decode kernel cannot take n={bucket_n}, hidden={hidden}, "
                     f"max_deg={max_deg}" + (" in bf16" if bf16 else ""))


def decode_kernel_supported(bucket_n: int, hidden: int, max_deg: int = 6,
                            bf16: bool = False) -> bool:
    """True when one of the whole-decode kernel's templates in the storage
    type takes a (bucket_n, hidden) graph at any batch: the four-block
    cluster template's or the block template's shared memory fits (see
    :func:`decode_template`; the wide one takes no shape the block template
    refuses)."""
    try:
        decode_template(bucket_n, hidden, max_deg, bf16, clusters=0)
    except ValueError:
        return False
    return True


def wide_clusters(bucket_n: int, hidden: int, max_deg: int, bf16: bool = False) -> int:
    """How many clusters of the wide template the current card holds at once
    for a (bucket_n, hidden, max_deg) batch: the occupancy API's answer
    through the kernel's library (built and loaded at the first call), the
    number the launcher's batch rule divides by (0 where its shared memory
    does not fit a block).  Needs the card."""
    if decode_smem_bytes(bucket_n, hidden, max_deg, TEMPLATES[4 + bf16]) > MAX_SMEM_BYTES:
        return 0
    probe = build.load_function("ptr_decode", "ptr_decode_max_clusters",
                                [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    build.check("ptr_decode", probe(bucket_n, hidden, max_deg, int(bf16), WIDE,
                                    ctypes.byref(out)))
    return out.value


def step_uniforms(key, n: int) -> torch.Tensor:
    """The per-step uniforms of a sampled decode of ``n`` steps, float32 on
    the CPU: step ``i`` draws ``uniform(fold_in(key, i), ())``, the
    reference's stream (``repro.kernels.ptr.decode.step_uniforms``), so it
    does not depend on the padded length.  ``key`` is one (2,) uint32 key,
    giving (n,), or a batch of keys (B, 2), giving (B, n)."""
    from ...core import prng     # here: the core package imports this module
    key = np.asarray(key)
    return torch.from_numpy(prng.uniform(prng.fold_in(key[..., None, :], np.arange(n)), ()))


_P, _I = ctypes.c_void_p, ctypes.c_int
#: argument types of ``ptr_decode_launch``
ARGTYPES = [_P] * 20 + [_I] * 7 + [_P, ctypes.POINTER(ctypes.c_int)]


def stored_operands(net, C, emb, dtype: torch.dtype) -> list[torch.Tensor]:
    """The operands the bf16 templates store in bfloat16, in ``dtype``: C,
    CWg, CWp, emb (per graph), then dec0, Wx, Wh, Wqg, vg, Wqp, vp.  CWg and
    CWp are the float32 products of the float32 C and W_ref, converted after
    that (as the reference rounds them); W_ref itself is never rounded."""
    CWg, CWp = precompute_refs(net, C)
    ops = (C, CWg, CWp, emb, net.start_token(), net.dec.wx, net.dec.wh, net.glimpse.w_q,
           net.glimpse.v, net.pointer.w_q, net.pointer.v)
    return [x.to(device=C.device, dtype=dtype).contiguous() for x in ops]


def decode_batch_reference(net, C, emb, h0, c0, parent_mat, n_valid, uniforms=None, *,
                           bf16: bool = False):
    """Plain PyTorch whole decode with the kernel's contract (see
    :func:`decode_batch`).  ``bf16``: the :func:`stored_operands` rounded to
    bfloat16 and back, then the float32 decode, which is what the reference's
    ``bf16=True`` kernel computes."""
    if not bf16:
        return net.decode(C, emb, (h0, c0), parent_mat, n_valid=n_valid, uniforms=uniforms)
    C, CWg, CWp, emb, dec0, wx, wh, wqg, vg, wqp, vp = (
        x.float() for x in stored_operands(net, C, emb, torch.bfloat16))
    return net.decode(C, emb, (h0, c0), parent_mat, n_valid=n_valid, uniforms=uniforms,
                      logits_fn=lambda h, mask: reference_pointer_step(
                          C, CWg, CWp, h, wqg, vg, wqp, vp, mask),
                      cell=(dec0, wx, wh, net.dec.b))


def load_launcher():
    """``ptr_decode_launch`` of the kernel's library, built and loaded at the
    first call."""
    return build.load_function("ptr_decode", "ptr_decode_launch", ARGTYPES)


def decode_batch(net, C, emb, h0, c0, parent_mat, n_valid, uniforms=None, *,
                 bf16: bool = False):
    """Whole decode over a padded batch of encoded graphs.

    C, emb: (B, n, H) contexts and projected embeddings; h0, c0: (B, H)
    final encoder state; parent_mat: (B, n, D) int (-1 padded); n_valid:
    (B,) int; uniforms: (B, n) per-step draws for a sampled decode, None for
    greedy.  A node is selectable once every parent is visited.  Returns
    order (B, n) int64 and logp, entropy (B, n) float32, drained padded
    steps at zero logp and entropy.  ``bf16``: the bf16 storage templates
    (see the module's docstring).  Forward only: raises on a grad-requiring
    input (or parameter) in grad mode, on the CPU too
    (:func:`~repro_torch.kernels.ptr.kernel.refuse_grad`).
    """
    refuse_grad("decode_batch", C, emb, h0, c0, *net.parameters())
    if not C.is_cuda:
        return decode_batch_reference(net, C, emb, h0, c0, parent_mat, n_valid, uniforms,
                                      bf16=bf16)
    fn = load_launcher()
    *out, template = launch(fn, net, C, emb, h0, c0, parent_mat, n_valid, uniforms, bf16=bf16)
    build.LAUNCHES[template] += 1
    return tuple(out)


def launch(fn, net, C, emb, h0, c0, parent_mat, n_valid, uniforms=None, *, bf16: bool = False):
    """Launches ``fn`` — ``ptr_decode_launch`` of the kernel's library, or of
    an instrumented variant of it — on CUDA tensors with the contract of
    :func:`decode_batch`; returns order, logp, entropy and the name of the
    template that ran.  Counts nothing."""
    B, n, H = C.shape
    D = parent_mat.shape[-1]
    if not decode_kernel_supported(n, H, D, bf16):
        raise ValueError(f"ptr_decode kernel cannot take n={n}, hidden={H}, max_deg={D}"
                         + (" in bf16" if bf16 else ""))
    dev = C.device
    f32 = torch.float32
    f = lambda x: x.to(device=dev, dtype=f32).contiguous()
    C, CWg, CWp, emb, dec0, wx, wh, wqg, vg, wqp, vp = stored_operands(
        net, C, emb, torch.bfloat16 if bf16 else f32)
    args = [C, CWg, CWp, emb, dec0, f(h0), f(c0), wx, wh, f(net.dec.b), wqg, vg, wqp, vp]
    pm = parent_mat.to(device=dev, dtype=torch.int32).contiguous()
    nv = n_valid.to(device=dev, dtype=torch.int32).contiguous()
    unif = None if uniforms is None else f(uniforms)
    if unif is not None and tuple(unif.shape) != (B, n):
        raise ValueError(f"uniforms: expected {(B, n)}, got {tuple(unif.shape)}")
    order = torch.empty((B, n), dtype=torch.int32, device=dev)
    logp = torch.empty((B, n), dtype=f32, device=dev)
    ent = torch.empty((B, n), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launched = ctypes.c_int(-1)
    rc = fn(*(a.data_ptr() for a in args), pm.data_ptr(), nv.data_ptr(),
            None if unif is None else unif.data_ptr(),
            order.data_ptr(), logp.data_ptr(), ent.data_ptr(),
            B, n, H, D, int(unif is not None), int(bf16), dev.index or 0, stream,
            ctypes.byref(launched))
    build.check("ptr_decode", rc)
    return order.long(), logp, ent, TEMPLATES[launched.value]
