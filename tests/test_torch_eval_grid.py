"""The port's smoke uniform eval grid, on the CPU, held to the checked-in
``BENCH_eval.json`` (the JAX package's run with the respect-v1 release).

``run_grid(scenario_grid(smoke=True))`` with
``RespectScheduler.from_release(device="cpu")`` and
``ExactOracle(device="cpu")``, summarized as ``benchmarks/eval_grid.py``
summarizes it, equals the artifact's uniform-grid fields: every field of
every scenario record, of the aggregates, the flat guard keys and the
Table-I table.  Integers and flags exactly; floats (gaps, bottlenecks,
``param_gap_pct``: float64 re-derivations from equal integer assignments)
within 1e-12 relative.  Timing keys (``t_*``, ``speedup_*``) are left out.
The branch-and-bound budget is 30 s, not the artifact's 2 s, so a loaded
worker cannot cut a search short (each of the grid's searches takes a few
milliseconds, so the pinned 2 s run was never cut either).

A live differential: ``run_scenario`` of ``chain/k2`` through both
packages gives equal records but for the timings.
"""

import json
from pathlib import Path

import pytest
import torch

import repro.core as jcore
import repro.eval as jeval
from repro_torch.core import RespectScheduler
from repro_torch.eval import (ExactOracle, check_results, diff_results, run_grid,
                              run_scenario, scenario_grid, summarize)

torch.set_num_threads(1)

BENCH = json.loads((Path(__file__).resolve().parents[1] / "BENCH_eval.json").read_text())
RTOL = 1e-12          # float64 re-derivations from equal integer assignments
BB_MAX_N, BB_BUDGET_S = 12, 30.0


def tier_keys(bench: dict) -> set:
    """The artifact's keys that the uniform grid (and its meta) writes."""
    return {k for k in bench if not (k.startswith(("gen_", "hetero"))
                                     or k in ("generalization", "all_capacity_feasible"))}


@pytest.fixture(scope="module")
def sched():
    return RespectScheduler.from_release(device="cpu")


@pytest.fixture(scope="module")
def results(sched):
    return run_grid(scenario_grid(smoke=True), sched, ExactOracle(device="cpu"),
                    bb_max_n=BB_MAX_N, bb_budget_s=BB_BUDGET_S)


@pytest.fixture(scope="module")
def summary(results, sched):
    meta = {"smoke": True, "trained_agent": sched.release is not None, "bb_max_n": BB_MAX_N,
            "n_scenarios": len(results["scenarios"])}
    return json.loads(json.dumps(summarize(results, meta)))


def test_uniform_grid_reproduces_bench_eval(summary):
    assert set(summary) == tier_keys(BENCH)
    diffs = diff_results(summary, {k: BENCH[k] for k in summary}, rtol=RTOL)
    assert not diffs, "\n".join(diffs[:20])


def test_pinned_guard_keys(summary):
    assert summary["match_rate_respect"] == 0.8307692307692308
    assert summary["aggregate"]["respect"]["n"] == 130
    assert summary["beats_oracle_respect"] == 2
    assert summary["table1_matches_k4"] == 8
    assert summary["gap_mean_respect"] == pytest.approx(0.1748350923154038, rel=RTOL)
    assert summary["oracle_parity"] is True and summary["all_schedules_valid"] is True
    assert [r["name"] for r in summary["scenarios"]] == [r["name"] for r in BENCH["scenarios"]]


def test_check_results_finds_no_problem(results):
    assert check_results(results) == []
    assert all(r["oracle"]["parity"] for r in results["scenarios"])


def test_chain_k2_live_differential(sched):
    sc = next(s for s in scenario_grid(smoke=True) if s.name == "chain/k2")
    jsc = next(s for s in jeval.scenario_grid(smoke=True) if s.name == "chain/k2")
    got = run_scenario(sc, sched, ExactOracle(device="cpu"), bb_budget_s=BB_BUDGET_S)
    want = jeval.run_scenario(jsc, jcore.RespectScheduler.from_release(), jeval.ExactOracle(),
                              bb_budget_s=BB_BUDGET_S)
    got = json.loads(json.dumps(got))
    want = json.loads(json.dumps(want))
    assert "_gaps" in got["policies"]["respect"]
    diffs = diff_results(got, want, rtol=0.0)
    assert not diffs, "\n".join(diffs[:20])
