"""The whole-decode kernel's wide template, and its block template at widths
its thread groups do not divide, against the plain version on the card
(every test here is marked ``cuda`` and skips without one).

* ``ptr_decode_wide_f32`` / ``ptr_decode_wide_bf16`` (hidden 256, seeded
  as ``RespectScheduler.init(seed=0)``): greedy and sampled, at bucket 1024
  with the largest Table-I graph alone and with two, and at a ragged bucket
  (three graphs of 33 – 60 nodes padded to 64); also at hidden 192;
* ``ptr_decode_block`` at hidden 96, 384 and 640 (bucket 32 and 512): the
  widths whose thread groups now loop over the columns;
* the template each call ran, by its launch counter.

Orders equal, logp and entropy within 1e-3 (``chip_smoke.py``'s
``TOL_LOGP``): float32 drift carried through up to 782 LSTM steps or a
384-wide cell; the kernel sums the same operands as the plain version in
another order.  No JAX import: the plain version is the reference here.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import RespectScheduler, build_model_graph, sample_batch
from repro_torch.core.batching import pack_padded
from repro_torch.kernels.ptr import ops
from repro_torch.kernels.ptr.decode import (decode_batch, decode_batch_reference,
                                            decode_template, wide_clusters)

MAX_DEG = 6
TOL = 1e-3
GOLDEN = Path(__file__).parent / "golden" / "dnn_schedules.json"
_NETS: dict[int, object] = {}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


def _net(hidden):
    """``RespectScheduler.init(seed=0, hidden=hidden)``'s network, on the card."""
    if hidden not in _NETS:
        _NETS[hidden] = RespectScheduler.init(seed=0, hidden=hidden).net
    return _NETS[hidden]


def _table1(k):
    """The k largest Table-I graphs, the largest first."""
    names = json.loads(GOLDEN.read_text())["models"]
    return sorted((build_model_graph(nm) for nm in names), key=lambda g: -g.n)[:k]


def _kernel_vs_plain(net, graphs, template, pad_n=None, bf16=False):
    batch = pack_padded(graphs, pad_n, MAX_DEG).to("cuda")
    n = batch.bucket_n
    valid = torch.arange(n, device="cuda")[None, :] < batch.n_valid[:, None].long()
    gen = torch.Generator(device="cuda").manual_seed(n)
    u = torch.rand((len(graphs), n), generator=gen, device="cuda")
    with torch.inference_mode():
        C, (h0, c0), emb = net.encode(batch.feats, batch.n_valid)
        args = (net, C, emb, h0, c0, batch.parent_mat, batch.n_valid)
        assert decode_template(n, net.hidden, MAX_DEG, bf16, batch=len(graphs),
                               clusters=wide_clusters(n, net.hidden, MAX_DEG, bf16)) == template
        for uniforms in (None, u):
            before = dict(ops.LAUNCHES)
            ko, kl, ke = decode_batch(*args, uniforms, bf16=bf16)
            after = dict(ops.LAUNCHES)
            po, pl, pe = decode_batch_reference(*args, uniforms, bf16=bf16)
            torch.cuda.synchronize()
            assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
                template: 1}
            assert torch.equal(torch.where(valid, ko, -1), torch.where(valid, po, -1))
            torch.testing.assert_close(kl, pl, atol=TOL, rtol=0)
            torch.testing.assert_close(ke, pe, atol=TOL, rtol=0)
            for i, g in enumerate(graphs):   # drained pads: ascending after the real nodes
                assert ko[i, g.n:].tolist() == list(range(g.n, n))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_wide_template_at_bucket_1024_on_cuda(k, bf16):
    _need_cuda()
    name = "ptr_decode_wide_bf16" if bf16 else "ptr_decode_wide_f32"
    _kernel_vs_plain(_net(256), _table1(k), name, bf16=bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_wide_template_at_a_ragged_bucket_on_cuda(bf16):
    _need_cuda()
    graphs = [sample_batch(np.random.default_rng(s), 1, n=n)[0]
              for s, n in ((70, 33), (71, 60), (72, 47))]
    name = "ptr_decode_wide_bf16" if bf16 else "ptr_decode_wide_f32"
    _kernel_vs_plain(_net(256), graphs, name, pad_n=64, bf16=bf16)


@pytest.mark.cuda
def test_wide_template_at_hidden_192_on_cuda():
    _need_cuda()
    graphs = sample_batch(np.random.default_rng(73), 5, n=(40, 120))
    _kernel_vs_plain(_net(192), graphs, "ptr_decode_wide_f32")


@pytest.mark.cuda
@pytest.mark.parametrize("hidden, pad_n", [(96, 32), (384, 32), (384, 512), (640, 32)])
def test_block_template_at_any_width_on_cuda(hidden, pad_n):
    _need_cuda()
    graphs = sample_batch(np.random.default_rng(hidden + pad_n), 4, n=(20, 30))
    if pad_n == 512:
        graphs = _table1(6)[-1:] + graphs[:1]   # DenseNet121 (429 nodes) and a small one
    _kernel_vs_plain(_net(hidden), graphs, "ptr_decode_block", pad_n=pad_n)
