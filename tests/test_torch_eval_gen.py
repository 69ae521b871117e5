"""The port's smoke large-graph generalization tier, on the CPU, held to
the checked-in ``BENCH_eval.json`` (the JAX package's run with respect-v1),
and the eval CLI ``python -m repro_torch.eval``.

``run_generalization(from_release(device="cpu"), smoke=True)`` — |V| =
100-200 graphs of the three synthetic families at k = 4, respect scored as
``rho`` over its decoded order — summarized by
``summarize_generalization``, equals the artifact's ``gen_*`` keys and its
``generalization`` table field for field (integers and flags exactly,
floats within 1e-12 relative, timing keys left out);
``check_generalization`` finds no problem.  The CLI writes the same payload
for ``--gen-only`` and refuses the full grid, whose ingest cells the port
cannot build.
"""

import json
from pathlib import Path

import pytest
import torch

from repro_torch.core import RespectScheduler
from repro_torch.eval import (check_generalization, diff_results, run_generalization,
                              summarize_generalization)
from repro_torch.eval.__main__ import main as eval_main

torch.set_num_threads(1)

BENCH = json.loads((Path(__file__).resolve().parents[1] / "BENCH_eval.json").read_text())
RTOL = 1e-12


def gen_keys(bench: dict) -> set:
    return {k for k in bench if k.startswith("gen_") or k == "generalization"}


@pytest.fixture(scope="module")
def results():
    return run_generalization(RespectScheduler.from_release(device="cpu"), smoke=True)


def test_generalization_tier_reproduces_bench_eval(results):
    summary = json.loads(json.dumps(summarize_generalization(results)))
    assert set(summary) == gen_keys(BENCH)
    diffs = diff_results(summary, {k: BENCH[k] for k in summary}, rtol=RTOL)
    assert not diffs, "\n".join(diffs[:20])
    assert summary["gen_gap_mean_respect"] == pytest.approx(0.005278833865741683, rel=RTOL)
    assert summary["gen_n_graphs"] == 12
    assert summary["gen_respect_beats_list"] is True and summary["gen_all_valid"] is True


def test_check_generalization_finds_no_problem(results):
    assert check_generalization(results) == []
    assert results["train_n_max"] < min(min(r["sizes"]) for r in results["scenarios"])


def test_cli_gen_only_writes_the_same_payload(tmp_path, capsys):
    out = tmp_path / "gen.json"
    assert eval_main(["--smoke", "--gen-only", "--check", "--device", "cpu",
                      "--out-json", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert payload["smoke"] is True and payload["trained_agent"] is True
    assert payload["bb_max_n"] == 12
    want = {k: BENCH[k] for k in gen_keys(BENCH)}
    want.update(smoke=True, trained_agent=True, bb_max_n=12)
    diffs = diff_results(payload, want, rtol=RTOL)
    assert not diffs, "\n".join(diffs[:20])
    lines = capsys.readouterr().out.splitlines()
    assert "# eval check: OK" in lines
    assert any(ln.startswith("gen/aggregate,0.0,n=12;") for ln in lines)


def test_cli_refuses_the_full_grid():
    with pytest.raises(SystemExit, match="queue A item 5"):
        eval_main(["--device", "cpu"])
    with pytest.raises(SystemExit):
        eval_main(["--smoke", "--gen-only", "--hetero-only"])
