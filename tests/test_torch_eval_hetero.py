"""The port's smoke heterogeneous-system eval tier, on the CPU, held to the
checked-in ``BENCH_eval.json`` (the JAX package's run with respect-v1).

``run_grid(hetero_grid(smoke=True))`` — per-stage cost profiles
(``hetero/k*``) and hard per-stage memory budgets (``memcap/*``) — with
``RespectScheduler.from_release(device="cpu")`` and
``ExactOracle(device="cpu")``, summarized by ``summarize_hetero``, equals
the artifact's ``hetero_*`` keys, ``all_capacity_feasible`` and the
``hetero`` table field for field (integers and flags exactly, floats within
1e-12 relative, timing keys left out); ``check_hetero`` finds no problem.
Branch-and-bound budget 30 s (see ``tests/test_torch_eval_grid.py``).

A live differential: ``run_scenario`` of ``memcap/k2`` through both
packages gives equal records but for the timings, capacity keys included.
"""

import json
from pathlib import Path

import pytest
import torch

import repro.core as jcore
import repro.eval as jeval
from repro_torch.core import RespectScheduler
from repro_torch.eval import (ExactOracle, check_hetero, diff_results, hetero_grid, run_grid,
                              run_scenario, summarize_hetero)

torch.set_num_threads(1)

BENCH = json.loads((Path(__file__).resolve().parents[1] / "BENCH_eval.json").read_text())
RTOL = 1e-12
BB_MAX_N, BB_BUDGET_S = 12, 30.0


@pytest.fixture(scope="module")
def sched():
    return RespectScheduler.from_release(device="cpu")


@pytest.fixture(scope="module")
def results(sched):
    return run_grid(hetero_grid(smoke=True), sched, ExactOracle(device="cpu"),
                    bb_max_n=BB_MAX_N, bb_budget_s=BB_BUDGET_S)


def test_hetero_tier_reproduces_bench_eval(results):
    summary = json.loads(json.dumps(summarize_hetero(results)))
    assert set(summary) == {k for k in BENCH
                            if k.startswith("hetero") or k == "all_capacity_feasible"}
    diffs = diff_results(summary, {k: BENCH[k] for k in summary}, rtol=RTOL)
    assert not diffs, "\n".join(diffs[:20])
    assert summary["hetero_match_rate_respect"] == 0.9555555555555556
    assert summary["all_capacity_feasible"] is True and summary["hetero_oracle_parity"] is True


def test_check_hetero_finds_no_problem(results):
    assert check_hetero(results) == []
    capped = [r for r in results["scenarios"] if r["family"] == "memcap"]
    assert len(capped) == 3 and all(r["oracle"]["capacity_ok"] for r in capped)
    assert all(r["policies"]["respect"]["all_capacity_ok"] for r in capped)


def test_memcap_k2_live_differential(sched):
    sc = next(s for s in hetero_grid(smoke=True) if s.name == "memcap/k2")
    jsc = next(s for s in jeval.hetero_grid(smoke=True) if s.name == "memcap/k2")
    got = run_scenario(sc, sched, ExactOracle(device="cpu"), bb_budget_s=BB_BUDGET_S)
    want = jeval.run_scenario(jsc, jcore.RespectScheduler.from_release(), jeval.ExactOracle(),
                              bb_budget_s=BB_BUDGET_S)
    got, want = json.loads(json.dumps(got)), json.loads(json.dumps(want))
    assert got["system"] == {"heterogeneous": True, "capacity_constrained": True}
    assert "capacity_ok_rate" in got["policies"]["list"]
    diffs = diff_results(got, want, rtol=0.0)
    assert not diffs, "\n".join(diffs[:20])
