"""Sharded execution on real ranks, slice b: qwen3-14b and qwen3-32b
(GQA with qk-norm on each rank's local heads) and llava-next-mistral-7b
(the VLM's patch prefix: its offsets in the loss, the prefill's cache and
the decode's ``kv_len``) on a (data, model) ``DeviceMesh`` of four gloo
ranks on the CPU, (1, 4) and (2, 2).

Each cell: prefill and greedy decode, the sharded ``value_and_grad`` and a
train step against the single-process port and the reference
(``tests/_torch_ranks.py`` has the inputs and bounds); every rank's
replicated values bit-equal; the (2, 2) llava-next world's two train steps
against the reference's own sharded step on 8 XLA host devices
(``tests/golden/torch_sharded_steps.json``).

The local-shard helpers these archs reach beyond the five of
tests/test_torch_sharded_exec.py, each on the
ranks other than 0 of a (1, 4) mesh: the vocabulary-parallel embedding
lookup and its gradient (every token in the rows of ranks 1-3), and the
resolved shardings of the archs' parameters, caches and batches against
the reference's rules.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_ranks as tr

torch.set_num_threads(1)

ARCHS = ("qwen3-14b", "llava-next-mistral-7b", "qwen3-32b")
CELLS = [(m, a) for m in tr.MESHES for a in ARCHS]


def _fault_inputs() -> dict:
    rng = np.random.default_rng(4)
    return {
        # a vocabulary of 16 rows split 4 ways; every token in rows 4-15
        "embed": {"table": rng.standard_normal((16, 6)).astype(np.float32),
                  "tokens": rng.integers(4, 16, (2, 5)).astype(np.int64),
                  "dout": rng.standard_normal((2, 5, 6)).astype(np.float32)},
    }


@pytest.fixture(scope="module")
def runs():
    return tr.run(ARCHS, [dict(kind="faults", mesh=(1, 4), **_fault_inputs())])


@pytest.mark.parametrize("cell", CELLS, ids=tr.cell_id)
def test_prefill_and_decode_match_single_process(runs, cell):
    tr.check_prefill_and_decode(runs, cell)


@pytest.mark.parametrize("cell", CELLS, ids=tr.cell_id)
def test_gradients_match_single_process_and_reference(runs, cell):
    tr.check_gradients(runs, cell)


@pytest.mark.parametrize("cell", CELLS, ids=tr.cell_id)
def test_train_step_matches_single_process_and_reference(runs, cell):
    tr.check_train_step(runs, cell)


@pytest.mark.parametrize("cell", CELLS, ids=tr.cell_id)
def test_replicated_values_bit_equal_across_ranks(runs, cell):
    tr.check_replicated(runs, cell)


def test_reference_sharded_steps_golden(runs):
    tr.check_golden(runs, "llava-next-mistral-7b")


def test_vlm_prefix_offsets(runs):
    """The patches sit before the text: the prefill fills n_patches + S
    positions of the cache and nothing after them, and decode step i writes
    position n_patches + S + i (kv_len counts the patches)."""
    cfg = tr.get_smoke_config("llava-next-mistral-7b")
    filled = cfg.n_patches + tr.S
    assert cfg.n_patches == 8
    for mesh in tr.MESHES:
        got = runs["cells"][(mesh, "llava-next-mistral-7b")][0]["arrays"]
        for name in ("k", "v"):
            pre = got[f"prefill/cache/blocks/u0/{name}"]       # (layers, B, max_len, kv, dh)
            dec = got[f"decode/cache/blocks/u0/{name}"]
            assert pre.shape[2] == filled + tr.DECODE
            assert np.abs(pre[:, :, :filled]).max(axis=(0, 1, 3, 4)).min() > 0
            assert not pre[:, :, filled:].any()
            np.testing.assert_array_equal(dec[:, :, :filled], pre[:, :, :filled])
            assert np.abs(dec[:, :, filled:]).max(axis=(0, 1, 3, 4)).min() > 0


def test_embedding_lookup_on_ranks_1_to_3(runs):
    inp = _fault_inputs()["embed"]
    assert inp["tokens"].min() >= 4                # no token in rank 0's rows
    table = torch.from_numpy(inp["table"]).requires_grad_(True)
    out = table[torch.from_numpy(inp["tokens"])]
    out.backward(torch.from_numpy(inp["dout"]))
    faults = runs["extra"][0]
    assert [f["model_rank"] for f in faults] == [0, 1, 2, 3]
    for r in faults[1:]:
        assert r["digests"] == faults[0]["digests"], f"rank {r['rank']}"
    tr.within(faults[0]["arrays"]["embed/out"], out.detach().numpy(), 1e-6, "out")
    tr.within(faults[0]["arrays"]["embed/dtable"], table.grad.numpy(), 1e-6, "d table")


@pytest.mark.parametrize("smoke", (True, False), ids=("smoke", "full"))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_resolve_like_the_reference(arch, smoke):
    assert tr.check_specs(arch, smoke) > 0
