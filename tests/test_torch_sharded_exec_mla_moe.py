"""Sharded execution on real ranks, slices c and d: minicpm3-4b (MLA: the
latents cached and split along the sequence, an absorbed decode) and the
two MoE archs, qwen3-moe-235b-a22b and kimi-k2-1t-a32b (the cumsum
dispatch over a batch-split token axis into experts split over ``model``),
on a (data, model) ``DeviceMesh`` of four gloo ranks on the CPU, (1, 4) and
(2, 2).  The loss rematerializes its unit bodies (``remat=True``) in the
ranks, the single process and the reference alike.

Each cell: prefill and greedy decode (with every MoE layer's routes, slot
positions and dropped slots equal to the single process's), the sharded
``value_and_grad`` and a train step against the single-process port and the
reference (``tests/_torch_ranks.py`` has the inputs and bounds; the MoE
archs run at a capacity factor that drops slots); every rank's replicated
values bit-equal; the (2, 2) worlds' two train steps of minicpm3-4b and
qwen3-moe against the reference's own sharded step on 8 XLA host devices
(``tests/golden/torch_sharded_steps.json``).

The local-shard helpers these archs reach, each on the ranks other than 0
of a (1, 4) mesh: the MoE's slot positions with the tokens split four ways
and every token of ranks 1-3 routed to experts another rank holds (so each
rank's positions need the counts of the ranks before it:
``models/common.exclusive_cumsum``'s prefix + correction), and an MLA
decode step whose latent-cache write straddles ranks 1 and 2 of a cache
split along the sequence, with the absorbed attention's softmax over that
split axis.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_ranks as tr

torch.set_num_threads(1)

ARCHS = ("minicpm3-4b", "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b")
MOE_ARCHS = ARCHS[1:]
GOLDEN_ARCHS = ("minicpm3-4b", "qwen3-moe-235b-a22b")
CELLS = [(m, a) for m in tr.MESHES for a in ARCHS]
N_EXPERTS, TOP_K, TOKENS = 8, 2, 32          # the MoE fault case: 8 tokens a rank
CACHE, KV_LEN, STEP = 16, 7, 2               # the MLA fault case: positions 7 and 8


def _fault_inputs() -> dict:
    rng = np.random.default_rng(5)
    # tokens split four ways (8 a rank); experts 2r, 2r + 1 on rank r.  Every
    # token of rank r >= 1 goes to two experts of other ranks, so its slot
    # positions count the earlier ranks' slots there
    top_e = np.empty((TOKENS, TOP_K), np.int64)
    for t in range(TOKENS):
        r = t // (TOKENS // 4)
        others = [x for x in range(N_EXPERTS) if x // 2 != r] if r else list(range(N_EXPERTS))
        top_e[t] = rng.choice(others, TOP_K, replace=False)
    prm = tr.params("minicpm3-4b")
    cfg = tr.smoke_config("minicpm3-4b")
    attn = {k: v[0] for k, v in prm["blocks"]["u0"]["attn"].items()}
    return {
        "moe": {"top_e": top_e, "n_experts": N_EXPERTS},
        "mla": {"arch": "minicpm3-4b", "params": attn, "kv_len": KV_LEN,
                "x": rng.standard_normal((2, STEP, cfg.d_model)).astype(np.float32),
                "ckv": rng.standard_normal((2, CACHE, cfg.kv_lora_rank)).astype(np.float32),
                "krope": rng.standard_normal((2, CACHE, cfg.qk_rope_head_dim)).astype(
                    np.float32)},
    }


@pytest.fixture(scope="module")
def runs():
    return tr.run(ARCHS, [dict(kind="faults", mesh=(1, 4), **_fault_inputs())], remat=True)


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


@pytest.mark.parametrize("arch", GOLDEN_ARCHS)
def test_reference_sharded_steps_golden(runs, arch):
    tr.check_golden(runs, arch)


@pytest.mark.parametrize("cell", [(m, a) for m in tr.MESHES for a in MOE_ARCHS], ids=tr.cell_id)
def test_moe_routes_drop_slots(runs, cell):
    """At the tests' capacity factor every MoE layer of the prefill drops
    slots, and the ranks' routes and drops (held equal to the single
    process's by the prefill check) are the same on every rank."""
    per_rank = runs["cells"][cell]
    got = per_rank[0]["arrays"]
    keeps = [k for k in got if k.startswith("prefill/routes/") and k.endswith("/keep")]
    assert len(keeps) == tr.get_smoke_config(cell[1]).n_layers
    for k in keeps:
        assert not got[k].all() and got[k].any(), k
    for r in per_rank[1:]:
        assert all(r["digests"][k] == per_rank[0]["digests"][k]
                   for k in per_rank[0]["digests"] if "/routes/" in k)


def test_moe_slot_positions_on_ranks_1_to_3(runs):
    from repro_torch.models.mlp import slot_positions
    inp = _fault_inputs()["moe"]
    top_e = inp["top_e"]
    per = TOKENS // 4
    assert all(x // 2 != t // per for t in range(per, TOKENS) for x in top_e[t])
    flat = np.eye(N_EXPERTS, dtype=np.int64)[top_e.reshape(-1)]
    want = ((np.cumsum(flat, 0) - flat) * flat).sum(1).reshape(TOKENS, TOP_K)
    np.testing.assert_array_equal(slot_positions(torch.from_numpy(top_e), N_EXPERTS).numpy(),
                                  want)
    faults = runs["extra"][0]
    assert [f["model_rank"] for f in faults] == [0, 1, 2, 3]
    for r in faults:
        assert r["digests"]["moe/positions"] == faults[0]["digests"]["moe/positions"]
    got = faults[0]["arrays"]["moe/positions"]
    np.testing.assert_array_equal(got, want)
    assert (got[per:] > 0).any()         # counts that only the earlier ranks' slots give


def test_mla_decode_straddling_ranks_1_and_2(runs):
    """The latent cache of 16 positions split four ways (rank 1 holds 4-7,
    rank 2 holds 8-11): a two-token decode step at kv_len 7 writes both
    ranks' shards, and the absorbed attention over the 9 valid positions
    equals the single process's."""
    from repro_torch.models.attention import mla_forward
    inp = _fault_inputs()["mla"]
    assert KV_LEN < CACHE // 2 < KV_LEN + STEP            # ranks 1 and 2
    cache = {n: torch.from_numpy(inp[n].copy()) for n in ("ckv", "krope")}
    x = torch.from_numpy(inp["x"])
    out, _ = mla_forward({k: torch.from_numpy(v) for k, v in inp["params"].items()},
                         tr.smoke_config("minicpm3-4b"), x, torch.arange(STEP) + KV_LEN,
                         mode="decode", cache=cache, kv_len=KV_LEN)
    faults = runs["extra"][0]
    for r in faults[1:]:
        assert all(r["digests"][k] == faults[0]["digests"][k]
                   for k in ("mla/out", "mla/ckv", "mla/krope")), f"rank {r['rank']}"
    got = faults[0]["arrays"]
    tr.within(got["mla/out"], out.numpy(), 1e-5, "out")
    for n in ("ckv", "krope"):
        np.testing.assert_array_equal(got[f"mla/{n}"], cache[n].numpy())
        assert not np.array_equal(cache[n][:, KV_LEN: KV_LEN + STEP].numpy(),
                                  inp[n][:, KV_LEN: KV_LEN + STEP])


@pytest.mark.parametrize("smoke", (True, False), ids=("smoke", "full"))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_resolve_like_the_reference(arch, smoke):
    assert tr.check_specs(arch, smoke) > 0
