"""The port's ingest of all ten archs (``repro_torch.ingest``) against the JAX
package's (``repro.ingest``), on the CPU.

Three cases, each parametrised by arch over ``ARCH_IDS``:

* SMOKE configs, ``kind="prefill"`` at seq 16 (12 nodes);
* SMOKE configs, ``kind="train"`` (``model.loss`` forward) at seq 24 (32 nodes);
* full configs, ``kind="prefill"`` at ``BENCH_ingest.json``'s seq 64, at its
  ``oracle_n_nodes`` and ``gen_n_nodes`` (12 and 64).

The limits are ``tests/test_torch_ingest.py``'s: ``param_bytes_total`` equal
to the reference report's (an integer count of bytes), ``flops_total`` within
5 % (the reference's chunked attention computes whole key blocks, the port's
kernel records count the causal triangle; XLA folds some products), no
warning, the report's keys and traced ``seq_len`` equal to the reference's,
the graph valid, within ``n_nodes`` and in-degree 6, and bit-stable across
two traces.  The full configs' graph hashes of the archs that
``tests/golden/torch_ingest_hashes.json`` does not hold are pinned in
``tests/golden/torch_ingest_zoo_hashes.json``, written by
``python tests/test_torch_ingest_zoo.py``; ``chip_smoke.py`` holds the
card's hashes to it.

The VLM's sequence clamp (``trace_model`` raises ``seq_len`` to
``n_patches + 8`` for llava-next-mistral-7b, so the text stays positive) is
pinned below the patch count: full config at seq 16 and 64, SMOKE at seq 8
and 12, and through ``RespectScheduler.schedule_model`` at its default seq.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.ingest import ingest_model as jax_ingest_model
from repro.ingest import trace_model as jax_trace_model
from repro.ingest.pipeline import _trace_cached as jax_trace_cached
from repro.utils.hlo import analyze_hlo_instructions
from repro_torch.configs import ARCH_IDS
from repro_torch.core import RespectScheduler, validate_graph, validate_monotone
from repro_torch.ingest import coarsen_program, ingest_model, trace_model

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCH_ingest.json").read_text())
GOLDEN = ROOT / "tests" / "golden" / "torch_ingest_zoo_hashes.json"
EARLIER_GOLDEN = ROOT / "tests" / "golden" / "torch_ingest_hashes.json"
SEQ = BENCH["seq_len"]                                          # 64
FULL_NODES = (BENCH["oracle_n_nodes"], BENCH["gen_n_nodes"])    # 12, 64
FLOPS_RTOL = 0.05
MAX_DEG = 6
VLM = "llava-next-mistral-7b"


def _golden_archs() -> tuple:
    pinned = json.loads(EARLIER_GOLDEN.read_text())["graph_hash"]
    return tuple(a for a in ARCH_IDS if a not in pinned)


def reference_report(arch: str, *, smoke: bool, kind: str, seq_len: int) -> dict:
    """The reference report's totals, traced seq_len and warnings, which
    ``repro.ingest.ingest_model`` takes from its trace's records before it
    coarsens them (its coarsener, held to the port's in
    ``tests/test_torch_ingest.py``, takes 35 s on xlstm-350m's full
    config); its keys are those of the reference's SMOKE ingest report."""
    t = jax_trace_cached(arch, smoke=smoke, kind=kind, batch=1, seq_len=seq_len)
    prog = analyze_hlo_instructions(t.hlo_text)
    totals = prog.totals()
    keys = jax_ingest_model(arch, 12, smoke=True).report
    return {"keys": set(keys), "timing_keys": set(keys["timing"]), "seq_len": t.seq_len,
            "flops_total": totals["flops"], "param_bytes_total": totals["param_bytes"],
            "warnings": dict(prog.warnings)}


def check_against_reference(arch: str, n_nodes: int, *, smoke: bool, kind: str, seq_len: int):
    """Ingest ``arch`` in both packages and hold the port's report and graph
    to the limits above; return the port's result."""
    got = ingest_model(arch, n_nodes, smoke=smoke, kind=kind, seq_len=seq_len)
    want = reference_report(arch, smoke=smoke, kind=kind, seq_len=seq_len)
    rep, g = got.report, got.graph
    assert set(rep) == want["keys"] and set(rep["timing"]) == want["timing_keys"]
    assert rep["kind"] == kind and rep["seq_len"] == want["seq_len"]
    assert rep["param_bytes_total"] == want["param_bytes_total"]
    assert rep["flops_total"] == pytest.approx(want["flops_total"], rel=FLOPS_RTOL)
    assert rep["n_warnings"] == 0 and rep["warnings"] == {} == want["warnings"]
    validate_graph(g)
    assert g.n == rep["n_nodes"] <= n_nodes and g.max_in_degree <= MAX_DEG
    assert float(g.param_bytes.sum()) == rep["param_bytes_total"]
    return got


def check_bit_stable(arch: str, results: dict, *, smoke: bool, kind: str, seq_len: int):
    """A new trace (no cache) coarsens to the same graphs, hash for hash;
    ``results`` maps a node budget to the cached ingest at it."""
    prog = trace_model(arch, smoke=smoke, kind=kind, seq_len=seq_len).program
    for n_nodes, res in results.items():
        again = coarsen_program(prog, n_nodes, max_deg=MAX_DEG, model_name=res.graph.model_name)
        assert again.content_hash() == res.report["graph_hash"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_prefill_matches_reference(arch):
    res = check_against_reference(arch, 12, smoke=True, kind="prefill", seq_len=16)
    check_bit_stable(arch, {12: res}, smoke=True, kind="prefill", seq_len=16)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_matches_reference(arch):
    res = check_against_reference(arch, 32, smoke=True, kind="train", seq_len=24)
    check_bit_stable(arch, {32: res}, smoke=True, kind="train", seq_len=24)


@pytest.mark.parametrize("arch,n_nodes", [(a, n) for a in ARCH_IDS for n in FULL_NODES])
def test_full_prefill_matches_reference(arch, n_nodes):
    res = check_against_reference(arch, n_nodes, smoke=False, kind="prefill", seq_len=SEQ)
    golden = json.loads(GOLDEN.read_text())
    assert golden["seq_len"] == SEQ
    if arch in golden["graph_hash"]:
        assert res.report["graph_hash"] == golden["graph_hash"][arch][str(n_nodes)]
    else:       # whisper-tiny and xlstm-350m, pinned since they were ported
        earlier = json.loads(EARLIER_GOLDEN.read_text())
        assert res.report["graph_hash"] == earlier["graph_hash"][arch][str(n_nodes)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_prefill_bit_stable(arch):
    results = {n: ingest_model(arch, n, smoke=False, seq_len=SEQ) for n in FULL_NODES}
    check_bit_stable(arch, results, smoke=False, kind="prefill", seq_len=SEQ)


@pytest.mark.parametrize("smoke,seq_len,tokens,param_bytes,flops", [
    (False, 16, 1160, 14_483_996_672, 1.6971e13),
    (False, 64, 1160, 14_483_996_672, 1.6971e13),
    (True, 8, 16, None, 2_523_136),
    (True, 12, 16, None, 2_523_136),
])
def test_vlm_sequence_clamped_below_its_patches(smoke, seq_len, tokens, param_bytes, flops):
    """Below ``n_patches + 8`` both packages trace ``n_patches + 8`` tokens
    (the port raised on the full config and traced too few text tokens on
    the SMOKE one before it clamped)."""
    got = trace_model(VLM, smoke=smoke, seq_len=seq_len)
    assert got.seq_len == jax_trace_model(VLM, smoke=smoke, seq_len=seq_len).seq_len == tokens
    rep = check_against_reference(VLM, 12, smoke=smoke, kind="prefill", seq_len=seq_len).report
    jrep = jax_ingest_model(VLM, 12, smoke=smoke, seq_len=seq_len).report
    assert rep["seq_len"] == jrep["seq_len"] == tokens
    assert jrep["flops_total"] == pytest.approx(flops, rel=1e-4)
    if param_bytes is not None:
        assert rep["param_bytes_total"] == jrep["param_bytes_total"] == param_bytes
    assert got.program.totals()["flops"] == pytest.approx(jrep["flops_total"], rel=FLOPS_RTOL)


def test_schedule_model_of_the_vlm_at_its_default_seq():
    """``schedule_model`` of the full llava-next-mistral-7b at the default
    seq 16 (which raised before the clamp) equals ``schedule`` of its
    ingested graph and is dependency-valid."""
    sched = RespectScheduler.from_release(device="cpu")
    res = sched.schedule_model(VLM, 4, n_nodes=12, smoke=False, use_cache=False)
    g = ingest_model(VLM, 12, smoke=False, max_deg=sched.max_deg).graph
    want = sched.schedule(g, 4, use_cache=False)
    assert np.array_equal(res["order"], want["order"])
    assert np.array_equal(res["assignment"], want["assignment"])
    assert validate_monotone(g, res["assignment"], 4)
    assert res["ingest"]["seq_len"] == 1160 and res["ingest"]["graph_hash"] == g.content_hash()


def _hashes() -> dict:
    return {arch: {str(n): ingest_model(arch, n, smoke=False, seq_len=SEQ).report["graph_hash"]
                   for n in FULL_NODES} for arch in _golden_archs()}


if __name__ == "__main__":
    # rewrite the golden graph hashes of the full configs (seq 64, 12 and 64 nodes)
    GOLDEN.write_text(json.dumps({"seq_len": SEQ, "graph_hash": _hashes()}, indent=1) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
