"""The port's pointer ops against the reference's, and the CUDA kernels
against their plain versions.

On the CPU the port runs the plain PyTorch versions; they are held to the
reference's pure-jnp ops and to its Pallas kernels in interpret mode:

* the single-step pointer op: logits allclose at atol = rtol = 1e-5
  (float32 sums in another order);
* the whole decode, greedy and sampled (fed the reference's own per-step
  uniforms): orders equal, logp and entropy allclose at atol = 1e-4
  (float32 drift carried through n LSTM steps);
* padded equals unpadded at 1x and 2x buckets with mixed ``n_valid``.

The kernels themselves run only on the card: the ``cuda`` tests skip here.
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
from repro_torch.core.batching import bucket_for
from repro_torch.core.ptrnet import params_from_numpy
from repro_torch.kernels.ptr import ops
from repro_torch.kernels.ptr.decode import decode_batch, decode_batch_reference
from repro_torch.kernels.ptr.kernel import pointer_step_cuda
from repro_torch.kernels.ptr.ref import reference_pointer_step

# one intra-op thread: the suite runs in several worker processes at once,
# and per-process thread pools would oversubscribe the cores
torch.set_num_threads(1)

MAX_DEG = 6
HIDDEN = 32
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
    # hidden must divide the 512-thread block
    assert ops.decode_kernel_supported(1024, 128)
    assert not ops.decode_kernel_supported(1024, 96)
    assert not ops.step_kernel_supported(64, 640)
    # shared memory: 227 KB a block
    assert ops.decode_kernel_supported(4096, 128)
    assert not ops.decode_kernel_supported(8192, 128)
    assert ops.step_kernel_supported(16384, 128)
    assert not ops.step_kernel_supported(65536, 128)


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


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True])
def test_decode_kernel_matches_plain_on_cuda(sampled):
    _need_cuda()
    graphs = [_dag_case(s) for s in range(30, 38)]
    feats, pmat, nv = (torch.from_numpy(a).cuda() for a in _padded(graphs, 32))
    net = _NET.to("cuda")
    u = torch.rand(feats.shape[:2], device="cuda") if sampled else None
    with torch.inference_mode():
        C, (h0, c0), emb = net.encode(feats, nv)
        before = ops.LAUNCHES["ptr_decode"]
        ko, kl, ke = decode_batch(net, C, emb, h0, c0, pmat, nv, u)
        po, pl, pe = decode_batch_reference(net, C, emb, h0, c0, pmat, nv, u)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ptr_decode"] == before + 1
    assert torch.equal(ko, po)
    torch.testing.assert_close(kl, pl, atol=1e-4, rtol=0)
    torch.testing.assert_close(ke, pe, atol=1e-4, rtol=0)
