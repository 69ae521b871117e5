"""The port's bf16 whole decode (``decode_bf16``) against the reference's.

The reference's ``decode_batch(bf16=True)`` stores C, ``C @ W_ref`` of both
heads, emb, dec0 and the decoder weights but the bias in bfloat16 and sums in
float32.  On the CPU the port runs its plain bf16 version, which rounds the
same operands and decodes in float32; it is held to the Pallas kernel in
interpret mode:

* seeded DAGs at hidden 32 and 128, padded and unpadded, greedy and sampled
  (the reference's own per-step uniforms): orders equal, logp and entropy
  within 1e-4 (float32 sums in another order);
* the reference's own case (Xception and ResNet50 at its hidden-32 seeded
  parameters, ``tests/test_ptr_kernel.py``);
* ``RespectScheduler.from_release(decode_bf16=True)`` on the ten Table-I
  graphs and ``init(seed=0)`` on 64 synthetic ones: digests equal to
  ``tests/golden/torch_bf16_schedules.json`` (written by
  ``scripts/make_bf16_golden.py`` from the JAX package), whose buckets 256
  and 512 are re-derived from JAX here;
* the routing: the scan (a heterogeneous system) ignores ``decode_bf16``,
  ``decode_bf16=False`` keeps the float32 golden digests, and the template
  gates mirror the launcher's shared-memory arithmetic in bf16.

The bf16 templates themselves run only on the card
(``tests/test_torch_decode_bf16_cuda.py``).
"""

import hashlib
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import RespectScheduler as JaxScheduler
from repro.core import build_model_graph as jax_model_graph
from repro.core import ptrnet as jptrnet
from repro.core import sample_dag
from repro.kernels.ptr import decode as jdecode
from repro_torch.core import PipelineSystem, RespectScheduler, build_model_graph, sample_batch
from repro_torch.core.batching import BucketedDecoder, greedy_order, sample_order
from repro_torch.core.embedding import embed_dim, embed_graph
from repro_torch.core.prng import PRNGKey
from repro_torch.core.ptrnet import PointerNet, params_to_numpy
from repro_torch.kernels.ptr import ops
from repro_torch.kernels.ptr.decode import (decode_batch, decode_batch_reference,
                                            decode_smem_bytes, decode_template, stored_operands)

torch.set_num_threads(1)   # several worker processes share the cores

GOLDEN = Path(__file__).parent / "golden"
BF16 = json.loads((GOLDEN / "torch_bf16_schedules.json").read_text())
F32 = json.loads((GOLDEN / "dnn_schedules.json").read_text())
NAMES = BF16["meta"]["table1"]
MAX_DEG = 6
STAGES = 4
#: clusters of 16 wide blocks an H100 SXM holds at once at these shapes (the
#: occupancy probe of scripts/ptr_decode_phases.py --wide), as the card
#: would answer decode_template
H100_CLUSTERS = 7
TOL = 1e-4
HETERO = PipelineSystem(n_stages=STAGES, compute_rate=(4e12, 2e12, 4e12, 8e12),
                        link_bw=(320e6, 160e6, 320e6, 640e6))
# the reference's init_params(PRNGKey(h)) at width h, drawn on the host by
# the port (bit for bit the same leaves; tests/test_torch_prng.py), and the
# same tree as numpy arrays for the JAX package
_NETS = {h: PointerNet.init(embed_dim(MAX_DEG), h, key=PRNGKey(h)) for h in (32, 128)}
_JPARAMS = {h: params_to_numpy(net) for h, net in _NETS.items()}


def digest(a) -> str:
    return hashlib.sha256(np.asarray(a, dtype=np.int64).tobytes()).hexdigest()


def _padded(graphs, pad_n):
    B = len(graphs)
    feats = np.zeros((B, pad_n, embed_dim(MAX_DEG)), np.float32)
    pmat = np.full((B, pad_n, MAX_DEG), -1, np.int32)
    for i, g in enumerate(graphs):
        feats[i, : g.n] = embed_graph(g, MAX_DEG)
        pmat[i, : g.n] = g.parent_matrix(MAX_DEG)
    return feats, pmat, np.array([g.n for g in graphs], np.int32)


def _port_decode(net, feats, pmat, nv, unif=None, bf16=True):
    with torch.inference_mode():
        feats, pmat, nv = (torch.from_numpy(x) for x in (feats, pmat, nv))
        C, (h0, c0), emb = net.encode(feats, nv)
        u = None if unif is None else torch.from_numpy(np.asarray(unif))
        return decode_batch(net, C, emb, h0, c0, pmat, nv, u, bf16=bf16)


def _assert_same(got, want, nv=None):
    """Orders equal (on the real steps: the reference's sampled kernel draws
    the drained padded slots, the port takes them in ascending order, and
    nothing reads them), logp and entropy within TOL (zero on drains)."""
    order, logp, ent = (x.numpy() for x in got)
    jo, jl, je = (np.asarray(x) for x in want)
    if nv is not None:
        real = np.arange(order.shape[-1])[None, :] < nv[:, None]
        order, jo = np.where(real, order, -1), np.where(real, jo, -1)
    assert np.array_equal(order, jo)
    np.testing.assert_allclose(logp, jl, atol=TOL, rtol=0)
    np.testing.assert_allclose(ent, je, atol=TOL, rtol=0)


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("hidden", [32, 128])
def test_plain_bf16_matches_pallas_bf16(hidden, padded, sampled):
    rng = np.random.default_rng(hidden + 10 * padded)
    graphs = [sample_dag(np.random.default_rng(int(rng.integers(10_000))),
                         n=int(rng.integers(6, 17)), deg=int(rng.integers(1, 5)))
              for _ in range(3)]
    if not padded:     # the padded case's shapes: JAX reuses its compiled decode
        graphs = [sample_dag(np.random.default_rng(hidden + s), n=16, deg=3) for s in range(3)]
    feats, pmat, nv = _padded(graphs, 16 if padded else graphs[0].n)
    keys = jax.random.split(jax.random.PRNGKey(hidden + padded), len(graphs))
    unif = (np.stack([np.asarray(jdecode.step_uniforms(k, feats.shape[1])) for k in keys])
            if sampled else None)
    want = jdecode.decode_pack(_JPARAMS[hidden], feats, pmat, nv, keys if sampled else None,
                               sampled=sampled, interpret=True, bf16=True)
    _assert_same(_port_decode(_NETS[hidden], feats, pmat, nv, unif), want, nv)


def test_functional_orders_take_decode_bf16():
    # the functional decode with decode_bf16 is the reference's greedy_order
    # / sample_order with make_decode_fn(bf16=True) as decode_builder
    g = sample_dag(np.random.default_rng(7), n=14, deg=3)
    feats, pmat = embed_graph(g, MAX_DEG), g.parent_matrix(MAX_DEG)
    builder = lambda _p: jdecode.make_decode_fn(interpret=True, bf16=True)
    key = jax.random.PRNGKey(3)
    net, jp = _NETS[32], _JPARAMS[32]
    _assert_same(greedy_order(net, feats, pmat, decode="kernel", decode_bf16=True),
                 jptrnet.greedy_order(jp, feats, pmat, decode_builder=builder))
    _assert_same(sample_order(net, feats, pmat, np.asarray(key), decode="kernel",
                              decode_bf16=True),
                 jptrnet.sample_order(jp, feats, pmat, key, decode_builder=builder))


def test_reference_case_xception_resnet50():
    # tests/test_ptr_kernel.py's bf16 case: its seeded parameters at hidden 32
    net = PointerNet.init(embed_dim(MAX_DEG), 32, key=PRNGKey(0))
    jp = params_to_numpy(net)
    graphs = [build_model_graph(nm) for nm in ("Xception", "ResNet50")]
    feats, pmat, nv = _padded(graphs, 256)
    want = jdecode.decode_pack(jp, feats, pmat, nv, interpret=True, bf16=True)
    _assert_same(_port_decode(net, feats, pmat, nv), want)


def test_stored_operands_round_the_float32_projections():
    # CWg and CWp come from the float32 C and W_ref, rounded after the
    # product; rounding C first gives other values
    net = _NETS[128]
    C = torch.from_numpy(np.tanh(np.random.default_rng(0).standard_normal((2, 24, 128)))
                         .astype(np.float32))
    emb = C.flip(1)
    stored = stored_operands(net, C, emb, torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in stored)
    CWg = stored[1]
    assert torch.equal(CWg, (C @ net.glimpse.w_ref).to(torch.bfloat16))
    assert not torch.equal(CWg, (C.to(torch.bfloat16).float() @ net.glimpse.w_ref)
                           .to(torch.bfloat16))
    assert torch.equal(stored[0], C.to(torch.bfloat16))
    assert torch.equal(stored[5], net.dec.wx.to(torch.bfloat16))


def test_decode_batch_routes_cpu_tensors_to_plain_bf16():
    graphs = [sample_dag(np.random.default_rng(s), n=12, deg=2) for s in (1, 2)]
    feats, pmat, nv = (torch.from_numpy(x) for x in _padded(graphs, 16))
    net = _NETS[32]
    with torch.inference_mode():
        C, (h0, c0), emb = net.encode(feats, nv)
        before = dict(ops.LAUNCHES)
        a = decode_batch(net, C, emb, h0, c0, pmat, nv, bf16=True)
        b = decode_batch_reference(net, C, emb, h0, c0, pmat, nv, bf16=True)
        f = decode_batch_reference(net, C, emb, h0, c0, pmat, nv)
    assert ops.LAUNCHES == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], f[1])       # the rounding shows in logp


@pytest.fixture(scope="module")
def release_bf16():
    return RespectScheduler.from_release(device="cpu", decode_bf16=True)


@pytest.fixture(scope="module")
def table1():
    return [build_model_graph(nm) for nm in NAMES]


def test_release_table1_equals_bf16_golden(release_bf16, table1):
    res = release_bf16.schedule_many(table1, STAGES, use_cache=False)
    for nm, r in zip(NAMES, res):
        want = BF16["table1"][nm]
        assert digest(r["order"]) == want["order_sha256"], nm
        assert digest(r["assignment"]) == want["assign_sha256"], nm
    differ = [nm for nm, r in zip(NAMES, res)
              if digest(r["order"]) != F32["models"][nm]["order_sha256"]]
    assert differ == BF16["table1_differs_from_f32"]["order"]


def test_golden_buckets_256_512_equal_a_fresh_jax_run():
    names = [nm for nm in NAMES if BF16["table1"][nm]["bucket"] in (256, 512)]
    assert len(names) == 5
    sched = JaxScheduler.from_release(decode_impl="kernel-interpret", decode_bf16=True)
    assert sched.release["params_sha256"] == BF16["meta"]["release_params_sha256"]
    res = sched.schedule_many([jax_model_graph(nm) for nm in names], STAGES, use_cache=False)
    for nm, r in zip(names, res):
        assert digest(r["order"]) == BF16["table1"][nm]["order_sha256"], nm
        assert digest(r["assignment"]) == BF16["table1"][nm]["assign_sha256"], nm


@pytest.mark.parametrize("label", ["respect-v1", "init_seed0"])
def test_synthetic_equal_bf16_golden(label, release_bf16):
    sched = (release_bf16 if label == "respect-v1"
             else RespectScheduler.init(seed=0, device="cpu", decode_bf16=True))
    assert sched.hidden == BF16["meta"]["hidden"][label]
    synth = sample_batch(np.random.default_rng(0), 64, n=30)
    res = sched.schedule_many(synth, STAGES, use_cache=False)
    want = BF16["synthetic"][label]
    assert [digest(r["order"]) for r in res] == want["order_sha256"]
    assert [digest(r["assignment"]) for r in res] == want["assign_sha256"]


def test_float32_default_keeps_golden_digests(table1):
    # the graphs of buckets 256 and 512 whose bf16 orders differ from the
    # float32 ones
    names = [nm for nm in BF16["table1_differs_from_f32"]["order"]
             if BF16["table1"][nm]["bucket"] <= 512]
    assert names
    graphs = [table1[NAMES.index(nm)] for nm in names]
    res = RespectScheduler.from_release(device="cpu").schedule_many(graphs, STAGES,
                                                                     use_cache=False)
    for nm, r in zip(names, res):
        assert digest(r["order"]) == F32["models"][nm]["order_sha256"], nm
        assert digest(r["assignment"]) == F32["models"][nm]["assign_sha256"], nm


def test_scan_ignores_decode_bf16(release_bf16):
    # a heterogeneous system conditions the start token and takes the scan,
    # which has no bf16 mode (as in the reference)
    graphs = sample_batch(np.random.default_rng(1), 6, n=20)
    f32 = RespectScheduler.from_release(device="cpu")
    a = release_bf16.schedule_many(graphs, STAGES, HETERO, use_cache=False)
    b = f32.schedule_many(graphs, STAGES, HETERO, use_cache=False)
    for ra, rb in zip(a, b):
        assert np.array_equal(ra["order"], rb["order"])
        assert np.array_equal(ra["assignment"], rb["assignment"])
    dec = BucketedDecoder("cpu", decode_bf16=True)
    assert dec.resolve_decode_impl(32, 128, conditioned=True) == "scan"
    with pytest.raises(ValueError, match="profile-conditioned"):
        BucketedDecoder("cpu", decode_impl="kernel", decode_bf16=True).resolve_decode_impl(
            32, 128, conditioned=True)


def _state(n, hidden, max_deg=MAX_DEG):
    return decode_smem_bytes(n, hidden, max_deg, "ptr_decode_block") - 4 * 10 * hidden


def _case(bucket_n, hidden, f32, bf16, batch=1):
    return pytest.param(bucket_n, hidden, batch, f32, bf16,
                        id=f"{bucket_n}-{hidden}-{f32}-{bf16}")


@pytest.mark.parametrize("bucket_n, hidden, batch, f32, bf16", [
    _case(32, 128, "ptr_decode_cluster", "ptr_decode_cluster_bf16"),       # the release
    _case(1024, 128, "ptr_decode_cluster", "ptr_decode_cluster_bf16"),
    _case(4096, 128, "ptr_decode_block", "ptr_decode_cluster_bf16"),       # bf16 weights fit
    # init's default width: 64 graphs are too many waves for the wide template
    _case(32, 256, "ptr_decode_block", "ptr_decode_block_bf16", batch=64),
    _case(1024, 256, "ptr_decode_block", "ptr_decode_block_bf16", batch=64),
    _case(8, 32, "ptr_decode_cluster", "ptr_decode_cluster_bf16"),
    _case(1024, 256, "ptr_decode_wide_f32", "ptr_decode_wide_bf16"),       # one graph
])
def test_bf16_template_follows_launcher_arithmetic(bucket_n, hidden, batch, f32, bf16):
    kw = {"batch": batch, "clusters": H100_CLUSTERS}
    assert decode_template(bucket_n, hidden, MAX_DEG, **kw) == f32
    assert decode_template(bucket_n, hidden, MAX_DEG, bf16=True, **kw) == bf16
    # the cluster's Wx and Wh columns: 2 hidden^2 elements of 2 bytes in bf16;
    # h by parity and the bias of its units: 3 hidden floats
    cluster = decode_smem_bytes(bucket_n, hidden, MAX_DEG, "ptr_decode_cluster_bf16")
    assert cluster == 2 * 2 * hidden * hidden + 4 * 3 * hidden + _state(bucket_n, hidden)
    assert (decode_smem_bytes(bucket_n, hidden, MAX_DEG, "ptr_decode_cluster")
            == 4 * 2 * hidden * hidden + 4 * 3 * hidden + _state(bucket_n, hidden))
    # the block template keeps no weights: the same bytes in both types
    assert (decode_smem_bytes(bucket_n, hidden, MAX_DEG, "ptr_decode_block_bf16")
            == decode_smem_bytes(bucket_n, hidden, MAX_DEG, "ptr_decode_block"))
    assert (bf16 == "ptr_decode_cluster_bf16") == (cluster <= ops.MAX_SMEM_BYTES)
    assert ops.decode_kernel_supported(bucket_n, hidden, MAX_DEG, bf16=True)
    assert BucketedDecoder("cpu", decode_bf16=True).resolve_decode_impl(bucket_n, hidden) \
        == "kernel"


@pytest.mark.parametrize("bucket_n, hidden, max_deg", [
    (8192, 128, 6), (1024, 128, 64), (1024, 3006, 6), (64, 4096, 6)])
def test_bf16_template_refuses_what_both_refuse(bucket_n, hidden, max_deg):
    with pytest.raises(ValueError, match="cannot take .* in bf16"):
        decode_template(bucket_n, hidden, max_deg, bf16=True)
    assert not ops.decode_kernel_supported(bucket_n, hidden, max_deg, bf16=True)
    dec = BucketedDecoder("cpu", max_deg=max_deg, decode_bf16=True)
    assert dec.resolve_decode_impl(bucket_n, hidden) == "scan"
    with pytest.raises(ValueError, match="cannot take"):
        BucketedDecoder("cpu", max_deg=max_deg, decode_impl="kernel",
                        decode_bf16=True).resolve_decode_impl(bucket_n, hidden)
