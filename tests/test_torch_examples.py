"""The three example scripts' twins held to the reference on the CPU.

``tests/golden/torch_edge_deploy.json`` (``scripts/make_edge_deploy_golden.py``,
the JAX package) holds the reference's §IV loop, quickstart and the
serve_traffic pool.  Integers equal: each assignment's sha256, the monotone
flags, the per-stage op counts; floats (``bottleneck_s``, parameter bytes,
float64 re-derivations from equal assignments) within 1e-12 relative.

The whole loop takes ~20 s here at hidden 256 (RESPECT's plain decode), so
RESPECT runs on a stated subset of the table: Xception, ResNet50 and the two
models whose RESPECT rows differ from the exact solver's (ResNet101v2 at
k = 4 and 5, InceptionResNetv2 at k = 6), each at k = 4, 5, 6; the compiler
emulation and the exact solver run on all 30 rows; ``chip_smoke.py`` runs
the full table on the card.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from repro_torch import edge_pipeline_deploy as deploy
from repro_torch.core import (EDGETPU, RespectScheduler, build_model_graph, compiler_partition,
                              evaluate_schedule, exact_dp, validate_monotone)
from repro_torch.quickstart import quickstart
from repro_torch.serve_traffic import serve_traffic

GOLDEN = json.loads((Path(__file__).parent / "golden" / "torch_edge_deploy.json").read_text())
RTOL = 1e-12
SUBSET = ("Xception", "ResNet50", "ResNet101v2", "InceptionResNetv2")


@pytest.fixture(scope="module")
def agent():
    sched, trained = deploy.load_agent("no/such/agent.npz", "cpu")
    assert not trained and sched.hidden == GOLDEN["meta"]["hidden"]
    return sched


def _same_record(got: dict, want: dict, label: str) -> None:
    assert got["assign_sha256"] == want["assign_sha256"], label
    assert got["monotone"] == want["monotone"], label
    assert got["bottleneck_s"] == pytest.approx(want["bottleneck_s"], rel=RTOL), label


def test_golden_covers_the_table_and_its_respect_rows_differ_from_exact():
    rows = GOLDEN["deploy"]
    assert len(rows) == 30 and {r["k"] for r in rows} == set(deploy.DEPTHS)
    differ = {(r["model"], r["k"]) for r in rows
              if r["respect"]["assign_sha256"] != r["exact"]["assign_sha256"]}
    assert {("ResNet101v2", 4), ("InceptionResNetv2", 6)} <= differ
    assert all(r["respect"]["monotone"] for r in rows)


@pytest.mark.parametrize("model", SUBSET)
def test_deploy_rows_equal_the_reference(agent, model):
    rows = deploy.deploy_table(agent, models=[model])
    want = [r for r in GOLDEN["deploy"] if r["model"] == model]
    assert [(r["model"], r["k"], r["n"]) for r in rows] == \
        [(r["model"], r["k"], r["n"]) for r in want]
    for got, w in zip(rows, want):
        for method in deploy.METHODS:
            _same_record(got[method], w[method], f"{model} k={got['k']} {method}")
        assert got["speedup"] == pytest.approx(
            w["compiler"]["bottleneck_s"] / w["respect"]["bottleneck_s"], rel=RTOL)


def test_baselines_of_every_row_equal_the_reference():
    graphs = {}
    for w in GOLDEN["deploy"]:
        g = graphs.setdefault(w["model"], build_model_graph(w["model"]))
        k = w["k"]
        sys_ = EDGETPU.with_stages(k)
        a_e, _ = exact_dp(g, k, sys_)
        for method, a in (("compiler", compiler_partition(g, k, sys_)), ("exact", a_e)):
            got = {"assign_sha256": deploy.assignment_sha256(a),
                   "bottleneck_s": float(evaluate_schedule(g, a, sys_).bottleneck_s),
                   "monotone": bool(validate_monotone(g, a, k))}
            _same_record(got, w[method], f"{w['model']} k={k} {method}")


def test_quickstart_equals_the_reference(agent):
    want = GOLDEN["quickstart"]
    out = quickstart(agent, want["model"], want["stages"])
    for key in ("n", "max_in_degree", "depth"):
        assert out[key] == want[key], key
    assert out["param_bytes"] == pytest.approx(want["param_bytes"], rel=RTOL)
    by_name = {r["scheduler"]: r for r in out["rows"]}
    for name, method in (("compiler", "compiler"), ("exact", "exact"), ("RESPECT", "respect")):
        _same_record(by_name[name], want[method], f"quickstart {name}")
    assert [(p["stage"], p["ops"], p["over_cache"]) for p in out["placement"]] == \
        [(p["stage"], p["ops"], p["over_cache"]) for p in want["placement"]]
    np.testing.assert_allclose([p["param_bytes"] for p in out["placement"]],
                               [p["param_bytes"] for p in want["placement"]], rtol=RTOL)


def test_serve_traffic_results_equal_the_reference_pool():
    want = GOLDEN["serve_traffic"]
    sched = RespectScheduler.init(seed=0, hidden=want["hidden"], device="cpu")
    out = serve_traffic(sched, requests=12, stages=want["stages"])
    assert [g.n for g in out["pool"]] == [p["n"] for p in want["pool"]]
    assert [g.model_name for g in out["pool"]] == [p["model"] for p in want["pool"]]
    for burst in out["bursts"]:
        assert len(burst["results"]) == 12
        for i, r in zip(burst["pool_index"], burst["results"]):
            assert r["served_by"] == "policy"
            assert r.assignment.tolist() == want["pool"][i]["assignment"], i
    st = out["stats"]
    assert st.failed == 0 and st.degraded == 0 and st.retries == 0
    assert st.completed == st.requests == 24
    # a graph misses once (the warmup bypasses the cache); burst 2's repeats
    # of burst 1's graphs are cache hits
    first = set(out["bursts"][0]["pool_index"])
    second = out["bursts"][1]
    assert all(r["cache_hit"] for i, r in zip(second["pool_index"], second["results"])
               if i in first)
    assert st.cache_misses == len(first | set(second["pool_index"]))
    assert out["warm_keys"] and all(len(k) == 5 for k in out["warm_keys"])
