"""The port's pointer ops against the reference's, and the CUDA kernels
against their plain versions.

On the CPU the port runs the plain PyTorch versions; they are held to the
reference's pure-jnp ops and to its Pallas kernels in interpret mode:

* the single-step pointer op: logits allclose at atol = rtol = 1e-5
  (float32 sums in another order);
* the whole decode, greedy and sampled (fed the reference's own per-step
  uniforms): orders equal, logp and entropy allclose at atol = 1e-4
  (float32 drift carried through n LSTM steps);
* padded equals unpadded at 1x and 2x buckets with mixed ``n_valid``;
* the whole-decode kernel's template choice by shape and batch: the
  release's shapes (hidden 128, buckets 8..2048) take the four-block
  cluster template, the default width 256 the 16-block wide template for a
  few waves of graphs and the one-block template for more, and a shape no
  template takes raises;
* the single-step kernel's gate: any hidden width whose block fits the
  shared memory (96, 192, 384, 640 among them, which the whole decode now
  takes too), and its cluster size, one block per 128 rows up to 8.

The kernels themselves run only on the card: the ``cuda`` tests skip here.
On the card, the single-step kernel is held to its plain version at hidden
96, 128, 256 and 640, n from 8 to 4096, at five masks each (masked logits
byte-equal, the rest within 1e-4 relative); the cluster template is held
to the plain decode at hidden 32
and 128 and at bucket 1024 with drained steps, the block template at
hidden 256: orders equal, logp and entropy within 1e-4 at bucket 32, within
1e-3 (``chip_smoke.py``'s ``TOL_LOGP``) where float32 drift is carried
through up to 1000 LSTM steps or a 256-wide cell.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ptrnet as jptrnet
from repro.core import sample_dag
from repro.core.embedding import embed_dim, embed_graph
from repro.kernels.ptr import decode as jdecode
from repro.kernels.ptr.kernel import pointer_step_pallas
from repro.kernels.ptr.ref import reference_pointer_step as jax_pointer_step
from repro_torch.core.batching import BucketedDecoder, bucket_for
from repro_torch.core.ptrnet import params_from_numpy
from repro_torch.kernels.ptr import ops
from repro_torch.kernels.ptr.decode import (decode_batch, decode_batch_reference,
                                            decode_smem_bytes, decode_template)
from repro_torch.kernels.ptr.kernel import pointer_step_cuda, step_smem_bytes
from repro_torch.kernels.ptr.ref import reference_pointer_step

# one intra-op thread: the suite runs in several worker processes at once,
# and per-process thread pools would oversubscribe the cores
torch.set_num_threads(1)

MAX_DEG = 6
HIDDEN = 32
#: clusters of 16 wide blocks an H100 SXM holds at once at hidden 256 (the
#: occupancy probe of scripts/ptr_decode_phases.py --wide)
H100_CLUSTERS = 7
_JPARAMS = jptrnet.init_params(jax.random.PRNGKey(0), embed_dim(MAX_DEG), HIDDEN)
_NET = params_from_numpy(jax.tree.map(np.asarray, _JPARAMS))
_jax_step = jax.jit(jax.vmap(jax_pointer_step, in_axes=(0, 0, 0, 0, None, None, None, None, 0)))


def _step_inputs(B, n, H, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    mask = rng.random((B, n)) < 0.6
    mask[:, 0] = True
    if B > 1:
        mask[1] = False          # an all-masked row: every logit is -1e9
        mask[1, n // 2] = True   # ... except one
    scale = np.float32(1 / np.sqrt(H))
    return (f(B, n, H), f(B, n, H), f(B, n, H), f(B, H), f(H, H) * scale, f(H),
            f(H, H) * scale, f(H), mask)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("H", [32, 128])
@pytest.mark.parametrize("n", [8, 24, 64])
def test_plain_pointer_step_matches_reference_and_pallas(n, H, B):
    args = _step_inputs(B, n, H, seed=n * 1000 + H + B)
    got = reference_pointer_step(*map(torch.from_numpy, args)).numpy()
    jargs = tuple(map(jnp.asarray, args))
    want_ref = np.asarray(_jax_step(*jargs))
    want_pallas = np.asarray(pointer_step_pallas(*jargs, interpret=True))
    np.testing.assert_allclose(got, want_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want_pallas, atol=1e-5, rtol=1e-5)
    assert (got[~args[-1]] == -1e9).all()


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("H", [96, 640])
@pytest.mark.parametrize("n", [8, 64])
def test_plain_pointer_step_matches_reference_and_pallas_at_any_width(n, H, B):
    # widths that do not divide a 512-thread block, which the single-step
    # kernel takes as the reference does.  Its float32 sums run over H terms
    # of logits that grow as sqrt(H) (about 25 at H = 640), so the tolerance
    # of the 32- and 128-wide cases scales with H / 128
    args = _step_inputs(B, n, H, seed=n * 1000 + H + B)
    got = reference_pointer_step(*map(torch.from_numpy, args)).numpy()
    jargs = tuple(map(jnp.asarray, args))
    tol = 1e-5 * max(1.0, H / 128)
    np.testing.assert_allclose(got, np.asarray(_jax_step(*jargs)), atol=tol, rtol=tol)
    np.testing.assert_allclose(got, np.asarray(pointer_step_pallas(*jargs, interpret=True)),
                               atol=tol, rtol=tol)
    assert (got[~args[-1]] == -1e9).all()


def test_pointer_step_routes_cpu_tensors_to_plain_version():
    args = [torch.from_numpy(a) for a in _step_inputs(2, 16, HIDDEN, seed=5)]
    C, CWg, CWp, h, *_, mask = args
    before = dict(ops.LAUNCHES)
    out = ops.make_logits_fn(_NET, C)(h, mask)
    CWg, CWp = ops.precompute_refs(_NET, C)
    g, p = _NET.glimpse, _NET.pointer
    want = reference_pointer_step(C, CWg, CWp, h, g.w_q, g.v, p.w_q, p.v, mask)
    assert torch.equal(out, want)
    assert ops.LAUNCHES == before          # nothing launched on the CPU


def _uniform_costs(g):
    return dataclasses.replace(g, flops=np.full(g.n, 1.0e9), param_bytes=np.full(g.n, 1.0e6),
                               out_bytes=np.full(g.n, 1.0e5))


def _dag_case(seed):
    """The corpus of tests/test_decode_parity.py::dag_cases: a random DAG of
    6..16 nodes, in-degree 1..4, tie-heavy costs half of the time."""
    rng = np.random.default_rng(seed)
    n, deg = int(rng.integers(6, 17)), int(rng.integers(1, 5))
    g = sample_dag(np.random.default_rng(int(rng.integers(0, 10_000))), n=n, deg=deg)
    return _uniform_costs(g) if rng.random() < 0.5 else g


def _padded(graphs, pad_n):
    B = len(graphs)
    feats = np.zeros((B, pad_n, embed_dim(MAX_DEG)), np.float32)
    pmat = np.full((B, pad_n, MAX_DEG), -1, np.int32)
    for i, g in enumerate(graphs):
        feats[i, : g.n] = embed_graph(g, MAX_DEG)
        pmat[i, : g.n] = g.parent_matrix(MAX_DEG)
    return feats, pmat, np.array([g.n for g in graphs], np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_decode_matches_jax_scan_and_pallas(seed):
    g = _dag_case(seed)
    feats, pmat = embed_graph(g, MAX_DEG), g.parent_matrix(MAX_DEG)
    key = jax.random.PRNGKey(seed)
    unif = np.array(jdecode.step_uniforms(key, g.n))[None]
    t_feats, t_pmat = torch.from_numpy(feats)[None], torch.from_numpy(pmat)[None]
    with torch.inference_mode():
        C, (h0, c0), emb = _NET.encode(t_feats)
        for sampled in (False, True):
            u = torch.from_numpy(unif) if sampled else None
            order, logp, ent = decode_batch_reference(_NET, C, emb, h0, c0, t_pmat,
                                                      torch.tensor([g.n]), u)
            if sampled:
                jo, jl, je = jptrnet.sample_order(_JPARAMS, feats, pmat, key)
            else:
                jo, jl, je = jptrnet.greedy_order(_JPARAMS, feats, pmat)
            assert np.array_equal(order[0].numpy(), np.asarray(jo)), f"sampled={sampled}"
            np.testing.assert_allclose(logp[0].numpy(), np.asarray(jl), atol=1e-4)
            np.testing.assert_allclose(ent[0].numpy(), np.asarray(je), atol=1e-4)
            # the whole-decode Pallas kernel (interpret mode), same pack
            ko, kl, ke = jdecode.decode_pack(
                _JPARAMS, feats[None], pmat[None], jnp.asarray([g.n], jnp.int32),
                None if not sampled else key[None], sampled=sampled, interpret=True)
            assert np.array_equal(order.numpy(), np.asarray(ko))
            np.testing.assert_allclose(logp.numpy(), np.asarray(kl), atol=1e-4)
            np.testing.assert_allclose(ent.numpy(), np.asarray(ke), atol=1e-4)


def _encode_decode(feats, pmat, nv, u=None):
    """Pad-aware encode, then :func:`decode_batch` (plain on CPU tensors)."""
    feats, pmat, nv = (torch.as_tensor(x) for x in (feats, pmat, nv))
    C, (h0, c0), emb = _NET.encode(feats, nv)
    return decode_batch(_NET, C, emb, h0, c0, pmat, nv, u)


@pytest.mark.parametrize("mult", [1, 2])
def test_plain_decode_padded_equals_unpadded(mult):
    graphs = [_dag_case(s) for s in range(10, 16)]
    pad_n = bucket_for(max(g.n for g in graphs)) * mult
    feats, pmat, nv = _padded(graphs, pad_n)
    rng = np.random.default_rng(mult)
    unif = rng.random((len(graphs), pad_n)).astype(np.float32)
    with torch.inference_mode():
        for u in (None, torch.from_numpy(unif)):
            order, logp, ent = _encode_decode(feats, pmat, nv, u)
            for i, g in enumerate(graphs):
                f1, p1, _ = _padded([g], g.n)
                u1 = None if u is None else u[i: i + 1, : g.n]
                o1, l1, e1 = _encode_decode(f1, p1, np.array([g.n], np.int32), u1)
                assert torch.equal(order[i, : g.n], o1[0])
                assert sorted(order[i, : g.n].tolist()) == list(range(g.n))
                # drained pads: ascending, at exactly zero logp and entropy
                assert order[i, g.n:].tolist() == list(range(g.n, pad_n))
                assert (logp[i, g.n:] == 0).all() and (ent[i, g.n:] == 0).all()
                torch.testing.assert_close(logp[i, : g.n], l1[0], atol=1e-4, rtol=0)
                torch.testing.assert_close(ent[i, : g.n], e1[0], atol=1e-4, rtol=0)


def test_decode_batch_routes_cpu_tensors_to_plain_version():
    graphs = [_dag_case(s) for s in (20, 21)]
    feats, pmat, nv = map(torch.from_numpy, _padded(graphs, 16))
    with torch.inference_mode():
        C, (h0, c0), emb = _NET.encode(feats, nv)
        before = dict(ops.LAUNCHES)
        a = decode_batch(_NET, C, emb, h0, c0, pmat, nv)
        b = decode_batch_reference(_NET, C, emb, h0, c0, pmat, nv)
    assert ops.LAUNCHES == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kernel_gates_follow_cuda_limits():
    # any hidden width whose block template fits 227 KB: its thread groups
    # loop over the columns (64 bytes of vectors a unit, plus the state)
    assert ops.decode_kernel_supported(1024, 128)
    assert ops.decode_kernel_supported(1024, 96)
    assert ops.decode_kernel_supported(1024, 3005) and not ops.decode_kernel_supported(1024, 3006)
    assert ops.step_kernel_supported(64, 8205) and not ops.step_kernel_supported(64, 8206)
    # shared memory: 227 KB a block
    assert ops.decode_kernel_supported(4096, 128)
    assert not ops.decode_kernel_supported(8192, 128)
    assert ops.step_kernel_supported(16384, 128)
    assert not ops.step_kernel_supported(262144, 128)


@pytest.mark.parametrize("hidden", [96, 192, 384, 640])
def test_step_gate_takes_widths_the_whole_decode_refuses(hidden):
    # the single step loops its thread groups over any width; so does the
    # whole decode now (it refused these widths when its groups had to
    # divide the 512-thread block): uniform batches take it, and a
    # profile-conditioned one still the scan
    for n in (8, 32, 1024, 4096):
        assert ops.step_kernel_supported(n, hidden)
        assert step_smem_bytes(n, hidden) <= ops.MAX_SMEM_BYTES
    assert ops.decode_kernel_supported(1024, hidden)
    assert BucketedDecoder("cpu").resolve_decode_impl(1024, hidden) == "kernel"
    assert BucketedDecoder("cpu").resolve_decode_impl(1024, hidden, conditioned=True) == "scan"


@pytest.mark.parametrize("n, k", [(1, 1), (8, 1), (32, 1), (128, 1), (129, 2), (256, 2),
                                  (600, 5), (1024, 8), (4096, 8)])
def test_step_cluster_size_follows_n(n, k):
    # one block per 128 rows, at most 8 (the largest portable cluster); a
    # block's shared memory holds a score and a list entry per owned row
    assert ops.step_cluster_size(n) == k
    rows = -(-n // k)
    assert step_smem_bytes(n, 128) == 4 * (6 * 128 + 512 + 16 + k * 130 + rows) + 4 * (rows + 16)


@pytest.mark.parametrize("bucket_n", [8, 32, 256, 512, 1024, 2048])
def test_release_shapes_take_the_cluster_template(bucket_n):
    # the release's width: 8 H^2 = 128 KB of gate weights a block, h by
    # parity and the bias of its units (3 H floats), plus the per-graph state
    # (48 KB at bucket 1024), within 227 KB
    assert decode_template(bucket_n, 128, MAX_DEG) == "ptr_decode_cluster"
    smem = decode_smem_bytes(bucket_n, 128, MAX_DEG, "ptr_decode_cluster")
    state = decode_smem_bytes(bucket_n, 128, MAX_DEG, "ptr_decode_block") - 4 * 10 * 128
    assert smem == 8 * 128 * 128 + 4 * 3 * 128 + state <= ops.MAX_SMEM_BYTES
    assert BucketedDecoder("cpu").resolve_decode_impl(bucket_n, 128) == "kernel"


@pytest.mark.parametrize("bucket_n, hidden, batch, want", [
    pytest.param(8, 32, 1, "ptr_decode_cluster", id="8-32-ptr_decode_cluster"),
    pytest.param(1024, 32, 1, "ptr_decode_cluster", id="1024-32-ptr_decode_cluster"),
    pytest.param(4096, 64, 1, "ptr_decode_cluster", id="4096-64-ptr_decode_cluster"),
    # the cluster's state no longer fits
    pytest.param(4096, 128, 1, "ptr_decode_block", id="4096-128-ptr_decode_block"),
    # RespectScheduler.init's default width: 64 graphs take more waves of
    # 16-block clusters than the wide template is worth
    pytest.param(32, 256, 64, "ptr_decode_block", id="32-256-ptr_decode_block"),
    pytest.param(1024, 256, 64, "ptr_decode_block", id="1024-256-ptr_decode_block"),
    pytest.param(256, 512, 1, "ptr_decode_block", id="256-512-ptr_decode_block"),
    # one graph, or a few waves of them: the wide template
    pytest.param(1024, 256, 1, "ptr_decode_wide_f32", id="1024-256-ptr_decode_wide_f32"),
    pytest.param(32, 256, 14, "ptr_decode_wide_f32", id="32-256-ptr_decode_wide_f32"),
])
def test_template_follows_shape(bucket_n, hidden, batch, want):
    assert decode_template(bucket_n, hidden, MAX_DEG, batch=batch,
                           clusters=H100_CLUSTERS) == want
    assert decode_smem_bytes(bucket_n, hidden, MAX_DEG, want) <= ops.MAX_SMEM_BYTES
    assert ops.decode_kernel_supported(bucket_n, hidden, MAX_DEG)


@pytest.mark.parametrize("bucket_n, hidden, max_deg", [
    (8192, 128, 6),      # n too large for any template
    (1024, 128, 64),     # D too large: 256 KB of parent indices
    (1024, 3006, 6),     # any width, but the block's vectors and state exceed 227 KB
    (64, 4096, 6),
])
def test_template_refuses_oversized_shapes(bucket_n, hidden, max_deg):
    with pytest.raises(ValueError, match="cannot take"):
        decode_template(bucket_n, hidden, max_deg)
    assert not ops.decode_kernel_supported(bucket_n, hidden, max_deg)
    assert BucketedDecoder("cpu", max_deg=max_deg).resolve_decode_impl(bucket_n, hidden) == "scan"
    with pytest.raises(ValueError, match="cannot take"):
        BucketedDecoder("cpu", max_deg=max_deg, decode_impl="kernel").resolve_decode_impl(
            bucket_n, hidden)


# ---------------------------------------------------------------------- #
# on the card only
# ---------------------------------------------------------------------- #
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 64, 1024])
def test_step_kernel_matches_plain_on_cuda(n):
    _need_cuda()
    args = [torch.from_numpy(a).cuda() for a in _step_inputs(3, n, 128, seed=n)]
    before = ops.LAUNCHES["ptr_step"]
    got = pointer_step_cuda(*args)
    want = reference_pointer_step(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ptr_step"] == before + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _net_step_inputs(B, n, H, seed):
    """Single-step inputs (all but the mask) at the network's scale: C and h
    in (-1, 1) as an LSTM's outputs, CWg and CWp their projections, and the
    query weights and vectors of the reference's seeded init at width H.
    (``_step_inputs``' unit-normal rows and vectors give logits of tens at
    H = 640, where float32 rounding of the glimpse scores, amplified by the
    softmax, reaches the 1e-4 tolerance.)"""
    net = _net(H)
    rng = np.random.default_rng(seed)
    C = torch.from_numpy(np.tanh(rng.standard_normal((B, n, H))).astype(np.float32))
    h = torch.from_numpy(np.tanh(rng.standard_normal((B, H))).astype(np.float32))
    g, p = net.glimpse, net.pointer
    return [C, *ops.precompute_refs(net, C), h, g.w_q, g.v, p.w_q, p.v]


def _b2_masks(B, n, seed):
    """The masks B2 is held to on the card, by name: ``_step_inputs``'s,
    selectable rows inside one block's range only, one selectable row in the
    last block, every row masked, and a drained tail (the unvisited padded
    slots once every real node is visited)."""
    k = ops.step_cluster_size(n)
    rng = np.random.default_rng(seed)
    lo, hi = (k // 2) * n // k, (k // 2 + 1) * n // k
    one_block = np.zeros((B, n), bool)
    one_block[:, lo:hi] = rng.random((B, hi - lo)) < 0.5
    one_block[:, lo] = True
    last = np.zeros((B, n), bool)
    last[np.arange(B), [n - 1, (k - 1) * n // k, n - 1][:B]] = True
    drained = np.zeros((B, n), bool)
    for b in range(B):
        drained[b, n - 1 - (b * n) // (2 * B):] = True
    return {"step_inputs": _step_inputs(B, n, 8, seed)[-1], "one block": one_block,
            "last block, one row": last, "all masked": np.zeros((B, n), bool),
            "drained tail": drained}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 32, 256, 1024, 4096])
@pytest.mark.parametrize("H", [96, 128, 256, 640])
def test_step_kernel_any_width_and_mask_on_cuda(H, n):
    # masked logits byte-equal to the plain version's (-1e9), selectable ones
    # within 1e-4 of it relative to max(1, |logit|) (chip_smoke.py's
    # TOL_LOGITS): float32 sums in another order, the glimpse softmax
    # combined over the cluster's blocks.  The inputs are at the network's
    # scale (see _net_step_inputs)
    _need_cuda()
    args = [a.cuda() for a in _net_step_inputs(3, n, H, seed=n + H)]
    for name, m in _b2_masks(3, n, seed=n * H).items():
        mask = torch.from_numpy(m).cuda()
        before = ops.LAUNCHES["ptr_step"]
        got = pointer_step_cuda(*args, mask)
        want = reference_pointer_step(*args, mask)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["ptr_step"] == before + 1
        assert torch.equal(got[~mask], want[~mask]), name
        assert (got[~mask] == -1e9).all(), name
        err = (got[mask] - want[mask]).abs() / want[mask].abs().clamp_min(1.0)
        assert not mask.any() or float(err.max()) <= 1e-4, (name, float(err.max()))


_NETS = {HIDDEN: _NET}


def _net(hidden):
    """A pointer net of the given width from the reference's seeded init."""
    if hidden not in _NETS:
        jp = jptrnet.init_params(jax.random.PRNGKey(hidden), embed_dim(MAX_DEG), hidden)
        _NETS[hidden] = params_from_numpy(jax.tree.map(np.asarray, jp))
    return _NETS[hidden]


def _kernel_vs_plain(net, graphs, pad_n, sampled, template, tol):
    feats, pmat, nv = (torch.from_numpy(a).cuda() for a in _padded(graphs, pad_n))
    net = net.to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(pad_n)
    u = torch.rand(feats.shape[:2], generator=gen, device="cuda") if sampled else None
    with torch.inference_mode():
        C, (h0, c0), emb = net.encode(feats, nv)
        before = dict(ops.LAUNCHES)
        ko, kl, ke = decode_batch(net, C, emb, h0, c0, pmat, nv, u)
        after = dict(ops.LAUNCHES)
        po, pl, pe = decode_batch_reference(net, C, emb, h0, c0, pmat, nv, u)
    torch.cuda.synchronize()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {template: 1}
    assert torch.equal(ko, po)
    torch.testing.assert_close(kl, pl, atol=tol, rtol=0)
    torch.testing.assert_close(ke, pe, atol=tol, rtol=0)
    return ko, nv


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("hidden", [HIDDEN, 128])
def test_decode_kernel_matches_plain_on_cuda(hidden, sampled):
    _need_cuda()
    graphs = [_dag_case(s) for s in range(30, 38)]
    _kernel_vs_plain(_net(hidden), graphs, 32, sampled, "ptr_decode_cluster", 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True])
def test_cluster_template_drains_at_bucket_1024_on_cuda(sampled):
    _need_cuda()
    graphs = [sample_dag(np.random.default_rng(s), n=n, deg=3)
              for s, n in ((40, 700), (41, 1000), (42, 513))]
    order, nv = _kernel_vs_plain(_net(128), graphs, 1024, sampled, "ptr_decode_cluster", 1e-3)
    for i, g in enumerate(graphs):   # drained pads: ascending after the real nodes
        assert order[i, g.n:].tolist() == list(range(g.n, 1024))


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True])
def test_block_template_matches_plain_at_hidden_256_on_cuda(sampled):
    _need_cuda()
    # 64 graphs: more waves of 16-block clusters than the wide template takes
    graphs = [_dag_case(s) for s in range(50, 114)]
    _kernel_vs_plain(_net(256), graphs, 32, sampled, "ptr_decode_block", 1e-3)
