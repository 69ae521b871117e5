"""The port's ingest path (``repro_torch.ingest``) against the JAX package's
(``repro.ingest``), on the CPU.

* The coarsener: fed the reference's own records (``analyze_hlo_instructions``
  of the reference's ``trace_model(arch, smoke=True)``, copied into the
  port's ``InstrRecord``), the port's ``coarsen_program`` returns the
  reference's CompGraph field for field (parents, the three cost arrays
  bit-equal, names, model name) and its ``content_hash``, on both smoke
  configs at 12 and 64 nodes and on ``tests/test_ingest.py``'s random
  programs.  It conserves mass (flops and parameter bytes within 1e-12
  relative: float64 sums in another order), keeps its node budget and the
  in-degree limit, and is deterministic.
* The trace: ``param_bytes_total`` equals the reference report's exactly (an
  integer count of bytes) on both smoke configs and on both full configs
  (``BENCH_ingest.json``: 83,485,440 and 733,007,872); ``flops_total`` is
  within 5 % of the reference's (the two count the same matrix products;
  the reference's chunked attention computes whole key blocks, the port's
  kernel records count the causal triangle, and XLA folds a product with
  the zero initial state of the mLSTM's scan; PERF.md states the measured
  ratios).  No warning; every B3 and B4 call is one record; the loops are
  unrolled or aggregated as the reference's are.
* ``ingest_model``: the report has the reference's keys; the graphs are
  valid, within ``n_nodes`` and ``max_deg``, and bit-stable across two
  traces; their hashes equal ``tests/golden/torch_ingest_hashes.json``
  (written by ``python tests/test_torch_ingest.py``; ``chip_smoke.py``
  holds the card's hashes to the same file).
* ``RespectScheduler.schedule_model`` on the CPU equals ``schedule`` of the
  ingested graph and is dependency-valid.
* ``kind="train"`` (``model.loss`` forward, as the reference lowers it) on
  the SMOKE configs of whisper-tiny, xlstm-350m and zamba2-7b: parameter
  bytes equal the reference report's, flops within the same 5 %.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.ingest import coarsen_program as jax_coarsen_program
from repro.ingest import ingest_model as jax_ingest_model
from repro.ingest.pipeline import _trace_cached as jax_trace_cached
from repro.utils.hlo import HloProgram as JaxHloProgram
from repro.utils.hlo import InstrRecord as JaxInstrRecord
from repro.utils.hlo import analyze_hlo_instructions
from repro_torch.core import RespectScheduler, validate_graph, validate_monotone
from repro_torch.ingest import HloProgram, InstrRecord, coarsen_program, ingest_model, trace_model
from repro_torch.ingest.pipeline import _ingest_cached, _trace_cached

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCH_ingest.json").read_text())
GOLDEN = ROOT / "tests" / "golden" / "torch_ingest_hashes.json"
ARCHS = ("whisper-tiny", "xlstm-350m")
SEQ = BENCH["seq_len"]                      # 64, the eval's INGEST_SEQ_LEN
FULL_NODES = (BENCH["oracle_n_nodes"], BENCH["gen_n_nodes"])   # 12, 64
FLOPS_RTOL = 0.05


def bench_report(arch: str, n_nodes: int) -> dict:
    return next(r for r in BENCH["reports"] if r["arch"] == arch and r["n_nodes"] == n_nodes)


def to_port(prog) -> HloProgram:
    return HloProgram([InstrRecord(r.name, r.opcode, r.flops, r.out_bytes, r.param_bytes,
                                   tuple(r.operands)) for r in prog.instructions],
                      prog.entry, prog.n_raw_instructions, dict(prog.warnings), dict(prog.notes))


def same_graph(got, want):
    assert [list(p) for p in got.parents] == [list(p) for p in want.parents]
    for f in ("flops", "param_bytes", "out_bytes"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert list(got.names) == list(want.names) and got.model_name == want.model_name
    assert got.content_hash() == want.content_hash()


@pytest.fixture(scope="module", params=ARCHS)
def jax_records(request):
    arch = request.param
    text = jax_trace_cached(arch, smoke=True, kind="prefill", batch=1, seq_len=16).hlo_text
    return arch, analyze_hlo_instructions(text)   # the trace jax_ingest_model caches


# --------------------------------------------------------------------- #
# the coarsener, on the reference's records
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n_nodes", [12, 64])
def test_coarsener_reproduces_reference_on_its_records(jax_records, n_nodes):
    arch, jprog = jax_records
    name = f"ingest:{arch}:prefill:{n_nodes}"
    want = jax_coarsen_program(jprog, n_nodes, model_name=name)
    got = coarsen_program(to_port(jprog), n_nodes, model_name=name)
    same_graph(got, want)
    assert got.num_edges == want.num_edges and got.stats() == want.stats()


def _random_program(rng, n, record_cls, program_cls):
    """``tests/test_ingest.py``'s random record DAG, in either package's types."""
    recs = []
    for i in range(n):
        k = int(rng.integers(0, min(i, 3) + 1))
        ops = tuple(f"r{int(p)}" for p in rng.choice(i, size=k, replace=False)) if k else ()
        recs.append(record_cls(name=f"r{i}", opcode="dot", flops=float(rng.uniform(1e6, 1e9)),
                               out_bytes=float(rng.uniform(1e3, 1e6)),
                               param_bytes=float(rng.uniform(0, 1e6)), operands=ops))
    return program_cls(recs, "main", n)


@pytest.mark.parametrize("budget", [2, 5, 12])
def test_coarsener_on_random_programs(budget):
    rng_t, rng_j = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(5):
        n = int(rng_t.integers(20, 80))
        assert n == int(rng_j.integers(20, 80))
        prog = _random_program(rng_t, n, InstrRecord, HloProgram)
        jprog = _random_program(rng_j, n, JaxInstrRecord, JaxHloProgram)
        g = coarsen_program(prog, budget)
        same_graph(g, jax_coarsen_program(jprog, budget))
        # the reference's properties: budget, in-degree, mass
        validate_graph(g)
        assert 2 <= g.n <= budget and g.max_in_degree <= 6
        t = prog.totals()
        assert float(g.flops.sum()) == pytest.approx(t["flops"], rel=1e-12)
        assert float(g.param_bytes.sum()) == pytest.approx(t["param_bytes"], rel=1e-12)
        assert float(g.out_bytes.sum()) <= t["out_bytes"] + 1e-6


def test_coarsener_deterministic_and_refuses_empty():
    prog = _random_program(np.random.default_rng(11), 50, InstrRecord, HloProgram)
    assert len({coarsen_program(prog, 8).content_hash() for _ in range(3)}) == 1
    with pytest.raises(ValueError):
        coarsen_program(HloProgram([], None, 0), 4)
    with pytest.raises(ValueError):
        coarsen_program(prog, 1)


# --------------------------------------------------------------------- #
# the trace
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_trace_totals_match_reference(arch):
    want = jax_ingest_model(arch, 12, smoke=True).report
    got = ingest_model(arch, 12, smoke=True).report
    assert set(got) == set(want) and set(got["timing"]) == set(want["timing"])
    assert got["param_bytes_total"] == want["param_bytes_total"]
    assert got["flops_total"] == pytest.approx(want["flops_total"], rel=FLOPS_RTOL)
    assert got["n_warnings"] == 0 == want["n_warnings"]
    assert got["notes"]["expanded_loops"] >= 2 and "aggregated_loops" not in got["notes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_trace_totals_match_bench_ingest(arch):
    want = bench_report(arch, FULL_NODES[0])
    prog = _trace_cached(arch, smoke=False, kind="prefill", batch=1, seq_len=SEQ).program
    t = prog.totals()
    assert t["param_bytes"] == want["param_bytes_total"] == {
        "whisper-tiny": 83_485_440, "xlstm-350m": 733_007_872}[arch]
    assert t["flops"] == pytest.approx(want["flops_total"], rel=FLOPS_RTOL)
    assert prog.warnings == {}
    ops = [r.opcode for r in prog.instructions]
    if arch == "whisper-tiny":      # 4 encoder, 4 decoder self, 4 cross: B3, one record each
        assert ops.count("flash_fwd") == 12 and ops.count("ssd_scan") == 0
        assert prog.notes == {"expanded_loops": 2} and "loop" not in ops
    else:                           # 12 mLSTM layers x 2 scans: B4; sLSTM time loops
        assert ops.count("ssd_scan") == 24 and ops.count("flash_fwd") == 0
        # the reference's walker on XLA's program: 3 loops unrolled, 10 aggregated
        assert prog.notes == want["notes"] == {"expanded_loops": 3, "aggregated_loops": 10}
        assert ops.count("loop") == 10
    names = [r.name for r in prog.instructions]
    assert len(set(names)) == len(names)
    seen = set()
    for r in prog.instructions:   # operands precede their consumers
        assert set(r.operands) <= seen
        seen.add(r.name)


@pytest.mark.parametrize("arch", ARCHS + ("zamba2-7b",))
def test_train_trace_matches_reference(arch):
    """``kind="train"`` traces ``model.loss`` forward over the prefill's
    inputs, as the reference lowers it: parameter bytes equal, flops within
    the prefill kind's 5 %."""
    got = ingest_model(arch, 32, smoke=True, kind="train").report
    want = jax_ingest_model(arch, 32, smoke=True, kind="train").report
    assert got["kind"] == want["kind"] == "train"
    assert got["param_bytes_total"] == want["param_bytes_total"]
    assert got["flops_total"] == pytest.approx(want["flops_total"], rel=FLOPS_RTOL)
    assert got["n_warnings"] == 0
    with pytest.raises(ValueError):
        trace_model(arch, kind="decode")


def _hashes() -> dict:
    return {arch: {str(n): ingest_model(arch, n, smoke=False, seq_len=SEQ).report["graph_hash"]
                   for n in FULL_NODES} for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_nodes", FULL_NODES)
def test_ingest_model_full_config(arch, n_nodes):
    res = ingest_model(arch, n_nodes, smoke=False, seq_len=SEQ)
    rep, g = res.report, res.graph
    assert set(rep) == set(bench_report(arch, n_nodes)) - {"bit_stable"}
    validate_graph(g)
    assert g.n == rep["n_nodes"] <= n_nodes and g.max_in_degree <= 6
    assert rep["n_warnings"] == 0 and rep["seq_len"] == SEQ
    assert float(g.param_bytes.sum()) == rep["param_bytes_total"]
    assert float(g.flops.sum()) == pytest.approx(rep["flops_total"], rel=1e-12)
    golden = json.loads(GOLDEN.read_text())
    assert golden["seq_len"] == SEQ
    assert rep["graph_hash"] == golden["graph_hash"][arch][str(n_nodes)]
    assert ingest_model(arch, n_nodes, smoke=False, seq_len=SEQ) is res      # the cache


@pytest.mark.parametrize("arch", ARCHS)
def test_ingest_bit_stable_across_traces(arch):
    first = ingest_model(arch, 12)
    again = _ingest_cached.__wrapped__(arch, 12, True, "prefill", 1, 16, 6)   # no cache
    prog = trace_model(arch).program                                         # a new trace
    assert again.report["graph_hash"] == first.report["graph_hash"]
    assert coarsen_program(prog, 12, model_name=first.graph.model_name).content_hash() == \
        first.report["graph_hash"]


# --------------------------------------------------------------------- #
# schedule_model
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_schedule_model_equals_schedule_of_the_ingested_graph(arch):
    sched = RespectScheduler.from_release(device="cpu")
    res = sched.schedule_model(arch, 4, n_nodes=12, use_cache=False)
    g = ingest_model(arch, 12, max_deg=sched.max_deg).graph
    want = sched.schedule(g, 4, use_cache=False)
    assert np.array_equal(res["assignment"], want["assignment"])
    assert np.array_equal(res["order"], want["order"])
    assert validate_monotone(g, res["assignment"], 4)
    assert res["ingest"]["graph_hash"] == g.content_hash()
    assert res["ingest"]["arch"] == arch and res["ingest"]["n_nodes"] == g.n


if __name__ == "__main__":
    # rewrite the golden graph hashes of the full configs (seq 64, 12 and 64 nodes)
    GOLDEN.write_text(json.dumps({"seq_len": SEQ, "graph_hash": _hashes()}, indent=1) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
