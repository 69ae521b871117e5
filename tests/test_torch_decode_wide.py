"""The whole-decode kernel's wide template and its any-width block template,
on the CPU.

* ``decode_template``'s choice over (bucket, hidden, batch, storage type),
  with the card's count of 16-block clusters passed in: the four-block
  cluster template where it fits (hidden <= 128), the wide template for
  hidden widths above 128 that split 16 ways, while the batch takes at
  most ``WIDE_MAX_WAVES`` waves of clusters, else the block template at any
  width whose state fits;
* ``decode_smem_bytes`` mirrors the wide template's layout (its Wx, Wh,
  Wqg and Wqp columns, h by parity, bias, the state);
* widths the block's thread groups do not divide (96, 192, 384, 640) now
  take the whole decode for uniform batches, and still the scan for
  profile-conditioned ones, as in the reference;
* ``RespectScheduler.init(seed=0, hidden=384, device="cpu")`` schedules
  small graphs exactly as the reference's own Pallas kernel in interpret
  mode (``decode_impl="kernel-interpret"``) at the same width.

The kernels run only on the card (``tests/test_torch_decode_wide_cuda.py``).
"""

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.core.batching import BucketedDecoder
from repro_torch.kernels import build
from repro_torch.kernels.ptr import ops
from repro_torch.kernels.ptr.decode import (TEMPLATES, WIDE_MAX_WAVES, decode_smem_bytes,
                                            decode_template)

torch.set_num_threads(1)

MAX_DEG = 6
STAGES = 4
#: clusters of 16 wide blocks an H100 SXM holds at once at one block an SM
#: (the occupancy probe of scripts/ptr_decode_phases.py --wide)
H100_CLUSTERS = 7
F32 = ("ptr_decode_cluster", "ptr_decode_wide_f32", "ptr_decode_block")
BF16 = ("ptr_decode_cluster_bf16", "ptr_decode_wide_bf16", "ptr_decode_block_bf16")


def _state(n, hidden, max_deg=MAX_DEG):
    return decode_smem_bytes(n, hidden, max_deg, "ptr_decode_block") - 4 * 10 * hidden


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("bucket_n", [32, 256, 1024])
def test_wide_template_takes_a_few_waves_at_hidden_256(bucket_n, bf16):
    cluster, wide, block = BF16 if bf16 else F32
    clusters = H100_CLUSTERS
    for batch in (1, clusters, WIDE_MAX_WAVES * clusters):
        assert decode_template(bucket_n, 256, MAX_DEG, bf16, batch=batch,
                               clusters=clusters) == wide
    for batch in (WIDE_MAX_WAVES * clusters + 1, 132):
        assert decode_template(bucket_n, 256, MAX_DEG, bf16, batch=batch,
                               clusters=clusters) == block
    # a card that holds more clusters at this shape takes larger batches
    assert decode_template(bucket_n, 256, MAX_DEG, bf16, batch=WIDE_MAX_WAVES * clusters + 1,
                           clusters=2 * clusters) == wide
    # a card that holds none (or a shape it cannot place) runs the block template
    assert decode_template(bucket_n, 256, MAX_DEG, bf16, batch=1, clusters=0) == block


@pytest.mark.parametrize("bucket_n, hidden, bf16, want", [
    (1024, 128, False, "ptr_decode_cluster"),        # the release: never wide
    (32, 64, True, "ptr_decode_cluster_bf16"),       # serve_traffic's width
    (4096, 128, False, "ptr_decode_block"),          # hidden 128 is the cluster's, not wide's
    (32, 144, False, "ptr_decode_wide_f32"),         # the smallest wide width: 9 units a block
    (1024, 192, False, "ptr_decode_wide_f32"),
    (512, 384, True, "ptr_decode_wide_bf16"),        # 213 KB of bf16 columns and state
    (512, 384, False, "ptr_decode_block"),           # its float32 columns do not fit
    (1024, 384, True, "ptr_decode_block_bf16"),      # nor its bf16 ones at bucket 1024
    (64, 512, False, "ptr_decode_block"),            # 640 KB of float32 columns
    (32, 200, False, "ptr_decode_block"),            # does not split 16 ways
    (1024, 96, False, "ptr_decode_block"),           # the block template's any-width loops
    (1024, 640, True, "ptr_decode_block_bf16"),      # above the wide template's one unit a thread
])
def test_template_at_one_graph(bucket_n, hidden, bf16, want):
    assert decode_template(bucket_n, hidden, MAX_DEG, bf16, batch=1,
                           clusters=H100_CLUSTERS) == want
    assert decode_smem_bytes(bucket_n, hidden, MAX_DEG, want) <= ops.MAX_SMEM_BYTES
    assert ops.decode_kernel_supported(bucket_n, hidden, MAX_DEG, bf16)


@pytest.mark.parametrize("bucket_n, hidden", [(32, 256), (1024, 256), (512, 384), (64, 192)])
def test_wide_smem_mirrors_the_launcher(bucket_n, hidden):
    hq = hidden // 16
    for elem, name in ((4, "ptr_decode_wide_f32"), (2, "ptr_decode_wide_bf16")):
        # Wx and Wh columns (hidden x 4 hq each), Wqg and Wqp columns (hidden
        # x hq each), h by parity (2 hidden floats), bias (4 hq floats)
        want = elem * (2 * hidden * 4 * hq + 2 * hidden * hq) + 4 * (2 * hidden + 4 * hq)
        assert decode_smem_bytes(bucket_n, hidden, MAX_DEG, name) == want + _state(bucket_n,
                                                                                   hidden)
        assert want % 16 == 0       # the state that follows is read as float4
    # hidden 256, bucket 1024: 160 KB of float32 columns and 45 KB of state
    assert decode_smem_bytes(1024, 256, MAX_DEG, "ptr_decode_wide_f32") == 212356
    assert decode_smem_bytes(1024, 256, MAX_DEG, "ptr_decode_wide_bf16") == 130436


@pytest.mark.parametrize("bucket_n, hidden, bf16, want", [
    (1024, 128, False, "ptr_decode_cluster"),
    (1024, 96, False, "ptr_decode_block"),
    (1024, 640, True, "ptr_decode_block_bf16"),
    (512, 384, False, "ptr_decode_block"),           # the wide columns do not fit
    (1024, 256, False, "ptr_decode_wide_f32"),       # asked: the card's answer decides
    (1024, 256, True, "ptr_decode_block_bf16"),
])
def test_template_asks_the_card_only_where_the_wide_template_fits(bucket_n, hidden, bf16, want,
                                                                  monkeypatch):
    # without a cluster count decode_template asks the card (wide_clusters),
    # and only where the wide template's shape gate passes
    from repro_torch.kernels.ptr import decode
    asked = []

    def card(n, h, d, b):
        asked.append((n, h, d, b))
        return H100_CLUSTERS if not b else 0     # a card that cannot place the bf16 one

    monkeypatch.setattr(decode, "wide_clusters", card)
    assert decode_template(bucket_n, hidden, MAX_DEG, bf16, batch=1) == want
    assert asked == ([(bucket_n, hidden, MAX_DEG, bf16)] if hidden == 256 else [])


def test_wide_names_are_counted_apart():
    # chip_smoke.py and the tests match kernel names exactly: neither wide
    # name is a prefix of another template's
    wide = (TEMPLATES[4], TEMPLATES[5])
    assert wide == ("ptr_decode_wide_f32", "ptr_decode_wide_bf16")
    for w in wide:
        assert not any(t != w and (t.startswith(w) or w.startswith(t))
                       for t in TEMPLATES.values())
        assert w in build.LAUNCHES and w in ops.LAUNCHES
    assert sorted(TEMPLATES) == list(range(6))


@pytest.mark.parametrize("hidden", [96, 192, 384, 640])
def test_any_width_takes_the_whole_decode(hidden):
    dec = BucketedDecoder("cpu")
    for n in (8, 32, 1024):
        assert dec.resolve_decode_impl(n, hidden) == "kernel"
        assert BucketedDecoder("cpu", decode_impl="kernel").resolve_decode_impl(
            n, hidden) == "kernel"
    assert dec.resolve_decode_impl(32, hidden, conditioned=True) == "scan"
    with pytest.raises(ValueError, match="profile-conditioned"):
        BucketedDecoder("cpu", decode_impl="kernel").resolve_decode_impl(
            32, hidden, conditioned=True)


def test_hidden_384_equals_the_reference_kernel_interpret():
    # the width the reference's own kernel takes (a multiple of 128): its
    # Pallas whole decode in interpret mode against the port's plain decode
    seed = 11
    ref = jcore.RespectScheduler.init(seed=0, hidden=384, decode_impl="kernel-interpret")
    want = ref.schedule_many(jcore.sample_batch(np.random.default_rng(seed), 6, n=(10, 60)),
                             STAGES, use_cache=False)
    port = tcore.RespectScheduler.init(seed=0, hidden=384, device="cpu")
    graphs = tcore.sample_batch(np.random.default_rng(seed), 6, n=(10, 60))
    assert {port._decoder.resolve_decode_impl(b, 384)
            for b in tcore.batching.bucketize(graphs)} == {"kernel"}
    got = port.schedule_many(graphs, STAGES, use_cache=False)
    for i, (g, a, b) in enumerate(zip(graphs, got, want)):
        assert np.array_equal(a["order"], b["order"]), f"graph {i}: order"
        assert np.array_equal(a["assignment"], b["assignment"]), f"graph {i}: assignment"
        assert tcore.validate_monotone(g, a["assignment"], STAGES)
