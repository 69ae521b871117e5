"""Gap-to-optimal eval CLI: the port's twin of ``benchmarks/eval_grid.py``.

Scores the released policy, the compiler emulation and list scheduling
against the batched exact oracle on the scenario grid (synthetic families,
the ten Table-I graphs, the serving-traffic pool), plus the large-graph
generalization tier (``--gen-only`` runs just it, ``--no-gen`` skips it)
and the heterogeneous-system tier (``--hetero-only`` / ``--no-hetero``).
CSV lines ``name,us,derived`` stream to stdout; ``--out-json`` writes the
``BENCH_eval.json``-shaped payload (nothing is written without it);
``--check`` exits 1 on oracle-parity loss, an invalid scored schedule, a
schedule below the refined optimum, a capacity-infeasible respect/oracle
schedule or a generalization-tier failure.

    python -m repro_torch.eval --smoke --check --out-json /tmp/torch_eval.json
    python -m repro_torch.eval --smoke --device cpu      # without a card

The scheduler is the release at ``--release`` or the newest discovered one
(``checkpoints/respect-v*``, seeded weights with a warning if none).  It
runs on the card unless ``--device`` names another.  The full (non-smoke)
uniform grid holds the ingest cell ``ingest/k4``: whisper-tiny and
xlstm-350m traced on the meta device (:mod:`repro_torch.ingest`) and
coarsened to 12 nodes.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..core.respect import RespectScheduler
from .generalization import check_generalization, run_generalization
from .oracle import ExactOracle
from .report import (check_hetero, check_results, emit_lines, summarize,
                     summarize_generalization, summarize_hetero)
from .runner import run_grid
from .scenarios import hetero_grid, scenario_grid

BB_MAX_N = 12          # bb-refine the optimum on graphs up to this size
BB_BUDGET_S = 2.0


def emit(name: str, us_per_call: float, derived: str) -> str:
    line = f"{name},{us_per_call:.1f},{derived}"
    print(line, flush=True)
    return line


def _emit_gen(gen: dict) -> None:
    for rec in gen["scenarios"]:
        for name, pol in rec["policies"].items():
            emit(f"{rec['name']}/{name}", pol["t_s"] / max(rec["n_graphs"], 1) * 1e6,
                 f"gap_mean={pol['gap_mean']:.4f};gap_p95={pol['gap_p95']:.4f};"
                 f"valid={pol['all_valid']}")
    agg = gen["aggregate"]
    emit("gen/aggregate", 0.0,
         f"n={gen['n_graphs']};respect_gap={agg['respect']['gap_mean']:.4f};"
         f"list_gap={agg['list']['gap_mean']:.4f};"
         f"compiler_gap={agg['compiler']['gap_mean']:.4f};"
         f"beats_list={gen['gen_respect_beats_list']};"
         f"beats_compiler={gen['gen_respect_beats_compiler']};valid={gen['gen_all_valid']}")


def _hetero_emit(name: str, us: float, derived: str) -> None:
    """The hetero tier's aggregate rows renamed so they do not collide with
    the uniform grid's."""
    if name.startswith("eval/aggregate") or name == "eval/oracle_total":
        name = name.replace("eval/", "eval/hetero_", 1)
    emit(name, us, derived)


def run(smoke: bool = False, out_json: str | Path | None = None, check: bool = False,
        gen: bool = True, gen_only: bool = False, hetero: bool = True,
        hetero_only: bool = False, release: str | Path | None = None, device=None) -> dict:
    """Run the chosen tiers; returns the ``BENCH_eval.json``-shaped payload
    of what ran."""
    sched = RespectScheduler.from_release(release, device=device)
    oracle = ExactOracle(device=sched.device)
    meta = {"smoke": smoke, "trained_agent": sched.release is not None, "bb_max_n": BB_MAX_N}
    problems: list[str] = []

    gen_results = None
    if (gen or gen_only) and not hetero_only:
        gen_results = run_generalization(sched, smoke=smoke)
        _emit_gen(gen_results)
        problems += check_generalization(gen_results)

    hetero_results = None
    if (hetero or hetero_only) and not gen_only:
        hetero_results = run_grid(hetero_grid(smoke=smoke), sched, oracle,
                                  bb_max_n=BB_MAX_N, bb_budget_s=BB_BUDGET_S)
        emit_lines(hetero_results, _hetero_emit)
        problems += check_hetero(hetero_results)

    if gen_only:
        summary = dict(meta)
        summary.update(summarize_generalization(gen_results))
    elif hetero_only:
        summary = dict(meta)
        summary.update(summarize_hetero(hetero_results))
    else:
        scenarios = scenario_grid(smoke=smoke)
        meta["n_scenarios"] = len(scenarios)
        results = run_grid(scenarios, sched, oracle, bb_max_n=BB_MAX_N,
                           bb_budget_s=BB_BUDGET_S)
        emit_lines(results, emit)
        problems += check_results(results)
        summary = summarize(results, meta, generalization=gen_results)
        if hetero_results is not None:
            summary.update(summarize_hetero(hetero_results))
    if out_json is not None:
        Path(out_json).write_text(json.dumps(summary, indent=1) + "\n")
        print(f"# wrote {out_json}")

    if check:
        for p in problems:
            print(f"# eval check FAIL: {p}")
        print(f"# eval check: {'OK' if not problems else 'FAIL'}")
        if problems:
            raise SystemExit(1)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.eval")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced grid (the configuration BENCH_eval.json pins)")
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on oracle-parity loss, an invalid scored schedule, a "
                         "schedule below the refined optimum, or a generalization-tier "
                         "failure")
    ap.add_argument("--gen-only", action="store_true",
                    help="run ONLY the large-graph generalization tier")
    ap.add_argument("--no-gen", action="store_true", help="skip the generalization tier")
    ap.add_argument("--hetero-only", action="store_true",
                    help="run ONLY the heterogeneous-system tier")
    ap.add_argument("--no-hetero", action="store_true",
                    help="skip the heterogeneous-system tier")
    ap.add_argument("--release", default=None,
                    help="release directory to score (default: the newest under "
                         "checkpoints/)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    if args.gen_only and args.hetero_only:
        ap.error("--gen-only and --hetero-only are mutually exclusive")
    run(smoke=args.smoke, out_json=args.out_json, check=args.check, gen=not args.no_gen,
        gen_only=args.gen_only, hetero=not args.no_hetero, hetero_only=args.hetero_only,
        release=args.release, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
