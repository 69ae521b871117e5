"""Sharded execution on real ranks, slice a: whisper-tiny (encoder, self-
and cross-attention through B3 on local heads; a vocabulary the ``model``
axis may not divide) and xlstm-350m (the mLSTM's two B4 scans on local
heads, the sLSTM's time loop on each rank's rows) on a (data, model)
``DeviceMesh`` of four gloo ranks on the CPU, (1, 4) and (2, 2).

Each cell: prefill and greedy decode, the sharded ``value_and_grad`` and a
train step against the single-process port and the reference
(``tests/_torch_ranks.py`` has the inputs and bounds); every rank's
replicated values bit-equal; the (2, 2) xlstm-350m world's two train steps
against the reference's own sharded step on 8 XLA host devices
(``tests/golden/torch_sharded_steps.json``).

The local-shard helpers these archs reach beyond the five of
tests/test_torch_sharded_exec.py, each on the
ranks other than 0 of a (1, 4) mesh: the sLSTM's sharded training scan
(fault C12: its backward walked the time steps forward outside a trace),
the decode attention over a sequence-split cache (whisper's cross cache and
every self-attention cache), and the resolved shardings of the new archs'
inputs against the reference's rules.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_ranks as tr
from repro_torch.kernels.flash.ops import decode_attention
from repro_torch.models import ssm

torch.set_num_threads(1)

ARCHS = ("whisper-tiny", "xlstm-350m")
CELLS = [(m, a) for m in tr.MESHES for a in ARCHS]
NH, DH = 2, 4


def _fault_inputs() -> dict:
    rng = np.random.default_rng(3)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {
        # B = 2, S = 6, 2 heads of 4: the sLSTM scan whose backward C12 reversed
        "slstm": {"pre": f(2, 6, 4 * NH * DH), "r_h": f(NH, DH, 4 * DH) * 0.5,
                  "dout": f(2, 6, NH, DH), "nh": NH},
        # a cache of 8 positions split 4 ways (2 a rank); kv_len 5 ends inside
        # rank 2's shard, and rank 3's positions are all masked
        "decode": {"q": f(2, 4, 1, 8), "k": f(2, 2, 8, 8), "v": f(2, 2, 8, 8), "kv_len": 5},
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
    tr.check_golden(runs, "xlstm-350m")


# ------------------------------------------------------------------ helpers
def _plain_slstm(inp: dict):
    pre = torch.from_numpy(inp["pre"]).requires_grad_(True)
    r_h = torch.from_numpy(inp["r_h"]).requires_grad_(True)
    hs = ssm.slstm_scan(pre, r_h, NH)
    hs.backward(torch.from_numpy(inp["dout"]))
    return hs.detach(), pre.grad, r_h.grad


def test_c12_slstm_sharded_backward_runs_the_time_steps_in_reverse(runs):
    """C12: outside a trace the sharded scan's backward took the trace's
    loop, an ascending ``range``, for its reverse recursion: at these
    inputs (B = 2, S = 6, 2 heads of 4) ``d pre`` was 0.54 off and ``d r_h``
    0.72 on every rank.  Every rank now gives the plain scan's gradients."""
    inp = _fault_inputs()["slstm"]
    hs, dpre, dr_h = _plain_slstm(inp)
    for r in runs["extra"][0]:
        assert r["digests"] == runs["extra"][0][0]["digests"], f"rank {r['rank']}"
    got = runs["extra"][0][0]["arrays"]
    tr.within(got["slstm/hs"], hs.numpy(), 1e-6, "hs", rel_to_max=False)
    tr.within(got["slstm/dpre"], dpre.numpy(), 1e-6, "d pre", rel_to_max=False)
    tr.within(got["slstm/dr_h"], dr_h.numpy(), 1e-6, "d r_h", rel_to_max=False)


def test_slstm_backward_agrees_with_autograd_of_the_cell():
    """The scan's deferred backward against autograd through the same cell
    stepped forward: the reverse order is what makes them agree."""
    inp = _fault_inputs()["slstm"]
    _, dpre, dr_h = _plain_slstm(inp)
    pre = torch.from_numpy(inp["pre"]).requires_grad_(True)
    r_h = torch.from_numpy(inp["r_h"]).requires_grad_(True)
    b, s = pre.shape[:2]
    z = torch.zeros((b, NH, DH))
    c, n, h, m = z, z, z, torch.zeros((b, NH))
    hs = []
    for t in range(s):
        c, n, h, m = ssm._cell_math(pre[:, t], c, n, h, m, r_h, NH, DH)
        hs.append(h)
    torch.stack(hs, 1).backward(torch.from_numpy(inp["dout"]))
    tr.within(dpre.numpy(), pre.grad.numpy(), 1e-6, "d pre", rel_to_max=False)
    tr.within(dr_h.numpy(), r_h.grad.numpy(), 1e-6, "d r_h", rel_to_max=False)


def test_slstm_time_steps_order_and_the_trace_count():
    """Outside a trace the steps run last to first in the backward; under the
    dry run's recorder one step is traced and counted S times."""
    assert list(ssm._time_steps(6, reverse=True)) == [5, 4, 3, 2, 1, 0]
    assert list(ssm._time_steps(6, reverse=False)) == list(range(6))
    from repro_torch import trace_hooks
    from repro_torch.launch.dryrun import _Trace
    trace = _Trace({}, scopes=False)
    token = trace_hooks.RECORDER.set(trace)
    try:
        seen = []
        for t in ssm._time_steps(6, reverse=True):
            seen.append((t, trace.mult))
    finally:
        trace_hooks.RECORDER.reset(token)
    assert seen == [(5, 6)] and trace.mult == 1


def test_decode_attention_over_a_sequence_split_cache_on_ranks_1_to_3(runs):
    inp = _fault_inputs()["decode"]
    assert inp["kv_len"] // 2 == 2                      # the last valid key on rank 2
    q, k, v = (torch.from_numpy(inp[n]) for n in ("q", "k", "v"))
    want = decode_attention(q, k, v, inp["kv_len"])
    ke, ve = (t[:, :, : inp["kv_len"]].repeat_interleave(2, dim=1) for t in (k, v))
    plain = F.softmax(q @ ke.transpose(-1, -2) * 8 ** -0.5, -1) @ ve
    tr.within(want.numpy(), plain.numpy(), 1e-6, "plain decode")
    assert [r["model_rank"] for r in runs["extra"][0]] == [0, 1, 2, 3]
    tr.within(runs["extra"][0][0]["arrays"]["decode/out"], want.numpy(), 1e-6, "decode out")


@pytest.mark.parametrize("smoke", (True, False), ids=("smoke", "full"))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_resolve_like_the_reference(arch, smoke):
    assert tr.check_specs(arch, smoke) > 0
