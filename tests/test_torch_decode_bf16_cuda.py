"""The whole-decode kernel's bf16 storage templates against the plain bf16
version, on the card (every test here is marked ``cuda`` and skips without
one).

The twins of ``tests/test_torch_ptr_kernels.py``'s whole-decode checks,
with ``bf16=True``: the cluster template at hidden 32 and 128 (bucket 32),
and at bucket 1024 with drained steps, the block template at hidden 256.
Orders equal, logp and entropy within 1e-4 at bucket 32 and hidden 128,
within 1e-3 (``chip_smoke.py``'s ``TOL_LOGP``) where float32 drift is
carried through up to 1000 LSTM steps or a 256-wide cell: the kernel sums
the same rounded operands as the plain version in another order.  A shape
neither bf16 template takes raises on the card, as in float32.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import sample_dag
from repro_torch.core.embedding import embed_dim, embed_graph
from repro_torch.core.prng import PRNGKey
from repro_torch.core.ptrnet import PointerNet
from repro_torch.kernels.ptr import ops
from repro_torch.kernels.ptr.decode import decode_batch, decode_batch_reference

MAX_DEG = 6
_NETS: dict[int, PointerNet] = {}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


def _net(hidden):
    """The reference's seeded init at width ``hidden`` (key ``hidden``), on the card."""
    if hidden not in _NETS:
        _NETS[hidden] = PointerNet.init(embed_dim(MAX_DEG), hidden, key=PRNGKey(hidden)).cuda()
    return _NETS[hidden]


def _dag_case(seed):
    rng = np.random.default_rng(seed)
    n, deg = int(rng.integers(6, 17)), int(rng.integers(1, 5))
    return sample_dag(np.random.default_rng(int(rng.integers(0, 10_000))), n=n, deg=deg)


def _padded(graphs, pad_n):
    feats = np.zeros((len(graphs), pad_n, embed_dim(MAX_DEG)), np.float32)
    pmat = np.full((len(graphs), pad_n, MAX_DEG), -1, np.int32)
    for i, g in enumerate(graphs):
        feats[i, : g.n] = embed_graph(g, MAX_DEG)
        pmat[i, : g.n] = g.parent_matrix(MAX_DEG)
    nv = np.array([g.n for g in graphs], np.int32)
    return (torch.from_numpy(a).cuda() for a in (feats, pmat, nv))


def _kernel_vs_plain(net, graphs, pad_n, sampled, template, tol):
    feats, pmat, nv = _padded(graphs, pad_n)
    gen = torch.Generator(device="cuda").manual_seed(pad_n)
    u = torch.rand(feats.shape[:2], generator=gen, device="cuda") if sampled else None
    with torch.inference_mode():
        C, (h0, c0), emb = net.encode(feats, nv)
        before = dict(ops.LAUNCHES)
        ko, kl, ke = decode_batch(net, C, emb, h0, c0, pmat, nv, u, bf16=True)
        after = dict(ops.LAUNCHES)
        po, pl, pe = decode_batch_reference(net, C, emb, h0, c0, pmat, nv, u, bf16=True)
    torch.cuda.synchronize()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {template: 1}
    assert torch.equal(ko, po)
    torch.testing.assert_close(kl, pl, atol=tol, rtol=0)
    torch.testing.assert_close(ke, pe, atol=tol, rtol=0)
    return ko


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("hidden", [32, 128])
def test_bf16_cluster_template_matches_plain_on_cuda(hidden, sampled):
    _need_cuda()
    graphs = [_dag_case(s) for s in range(30, 38)]
    _kernel_vs_plain(_net(hidden), graphs, 32, sampled, "ptr_decode_cluster_bf16", 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True])
def test_bf16_cluster_template_drains_at_bucket_1024_on_cuda(sampled):
    _need_cuda()
    graphs = [sample_dag(np.random.default_rng(s), n=n, deg=3)
              for s, n in ((40, 700), (41, 1000), (42, 513))]
    order = _kernel_vs_plain(_net(128), graphs, 1024, sampled, "ptr_decode_cluster_bf16", 1e-3)
    for i, g in enumerate(graphs):   # drained pads: ascending after the real nodes
        assert order[i, g.n:].tolist() == list(range(g.n, 1024))


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True])
def test_bf16_block_template_matches_plain_at_hidden_256_on_cuda(sampled):
    _need_cuda()
    # 64 graphs: more waves of 16-block clusters than the wide template takes
    graphs = [_dag_case(s) for s in range(50, 114)]
    _kernel_vs_plain(_net(256), graphs, 32, sampled, "ptr_decode_block_bf16", 1e-3)


@pytest.mark.cuda
def test_bf16_refuses_a_shape_neither_template_takes_on_cuda():
    _need_cuda()
    net = _net(32)
    feats, pmat, nv = _padded([_dag_case(60)], 8192)
    with torch.inference_mode():
        C, (h0, c0), emb = net.encode(feats[:, :16], nv)
        C, emb = C.repeat(1, 512, 1), emb.repeat(1, 512, 1)   # n = 8192: no template fits
        before = dict(ops.LAUNCHES)
        with pytest.raises(ValueError, match="cannot take"):
            decode_batch(net, C, emb, h0, c0, pmat, nv, bf16=True)
    assert ops.LAUNCHES == before
