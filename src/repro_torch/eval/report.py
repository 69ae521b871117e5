"""Eval artifact writer: ``BENCH_eval.json`` + CSV lines (the port of
``repro.eval.report``).

The artifact's top level carries flat guard keys
(``match_rate_respect``, ``gap_p95_respect``, ``oracle_parity``,
``all_schedules_valid``, ``speedup_oracle_batched``, ...), the full
per-scenario and per-Table-I-model tables underneath: the reference's
schema key for key.  :func:`diff_results` holds one payload to another
(the checked-in ``BENCH_eval.json``) on every field but the timings.
"""

from __future__ import annotations

import json
from pathlib import Path

from .runner import POLICY_NAMES

__all__ = [
    "summarize",
    "summarize_hetero",
    "write_report",
    "emit_lines",
    "check_results",
    "check_hetero",
    "TIMING_PREFIXES",
    "diff_results",
]


def _strip_private(results: dict) -> dict:
    """Drop runner-internal keys (e.g. the raw per-graph gap lists) from
    a deep copy, keeping the artifact reviewable."""
    out = json.loads(json.dumps(
        {k: v for k, v in results.items()},
        default=lambda o: None))
    for rec in out.get("scenarios", []):
        for pol in rec.get("policies", {}).values():
            pol.pop("_gaps", None)
    return out


def summarize(results: dict, meta: dict | None = None,
              generalization: dict | None = None) -> dict:
    """The BENCH_eval.json payload: flat guard keys + full tables.

    ``generalization`` (optional): a :func:`repro_torch.eval.generalization
    .run_generalization` record — its flat guard keys (``gen_*``) and
    full tables ride along in the same artifact so ONE baseline pins the
    whole quality surface."""
    out: dict = dict(meta or {})
    out["oracle_parity"] = results["oracle_parity"]
    out["all_schedules_valid"] = results["all_schedules_valid"]
    out["speedup_oracle_batched"] = results["speedup_oracle_batched"]
    out["speedup_respect_vs_exact"] = results["speedup_respect_vs_exact"]
    for name in POLICY_NAMES:
        agg = results["aggregate"][name]
        out[f"match_rate_{name}"] = agg["match_rate"]
        out[f"gap_mean_{name}"] = agg["gap_mean"]
        out[f"gap_p95_{name}"] = agg["gap_p95"]
        out[f"gap_max_{name}"] = agg["gap_max"]
        out[f"beats_oracle_{name}"] = agg["beats_oracle"]
    stripped = _strip_private(results)
    out["aggregate"] = stripped["aggregate"]
    out["scenarios"] = stripped["scenarios"]
    # the Table-I per-model gap table (paper Tables II-III / Fig. 5 view)
    table1: dict = {}
    for rec in stripped["scenarios"]:
        if rec["family"] != "dnn":
            continue
        for g in rec.get("graphs", []):
            table1.setdefault(g["model"], {})[f"k{rec['n_stages']}"] = {
                k: v for k, v in g.items() if k != "model"}
    out["table1"] = table1
    # flat Table-I floor key: how many of the ten models the policy
    # schedules optimally at k=4 (the guard ratchets this — see
    # --min-table1-matches)
    k4 = [m.get("k4", {}).get("respect_match") for m in table1.values()]
    if any(v is not None for v in k4):
        out["table1_matches_k4"] = int(sum(bool(v) for v in k4))
    if generalization is not None:
        out.update(summarize_generalization(generalization))
    return out


def summarize_generalization(gen: dict) -> dict:
    """Flat ``gen_*`` guard keys + the full record, for merging into the
    eval artifact (or standing alone as the ``--gen-only`` artifact)."""
    out: dict = {}
    for name in POLICY_NAMES:
        agg = gen["aggregate"][name]
        out[f"gen_gap_mean_{name}"] = agg["gap_mean"]
        out[f"gen_gap_p95_{name}"] = agg["gap_p95"]
    for flag in ("gen_all_valid", "gen_respect_beats_list",
                 "gen_respect_beats_compiler"):
        out[flag] = gen[flag]
    out["gen_n_graphs"] = gen["n_graphs"]
    out["generalization"] = json.loads(json.dumps(gen))
    return out


def summarize_hetero(results: dict) -> dict:
    """Flat ``hetero_*`` guard keys + the full heterogeneous-tier record,
    for merging into the eval artifact (or standing alone as the
    ``--hetero-only`` artifact).  The tier runs as its own
    :func:`~repro_torch.eval.runner.run_grid` over
    :func:`~repro_torch.eval.scenarios.hetero_grid`, so none of the uniform
    grid's pinned keys move."""
    out: dict = {}
    out["hetero_oracle_parity"] = results["oracle_parity"]
    out["hetero_all_valid"] = results["all_schedules_valid"]
    # vacuously true when no memcap scenario ran (hard flag either way)
    out["all_capacity_feasible"] = results.get("all_capacity_feasible", True)
    for name in POLICY_NAMES:
        agg = results["aggregate"][name]
        out[f"hetero_match_rate_{name}"] = agg["match_rate"]
        out[f"hetero_gap_mean_{name}"] = agg["gap_mean"]
        out[f"hetero_gap_p95_{name}"] = agg["gap_p95"]
    stripped = _strip_private(results)
    out["hetero"] = {
        "aggregate": stripped["aggregate"],
        "scenarios": stripped["scenarios"],
        "oracle_parity": stripped["oracle_parity"],
        "all_schedules_valid": stripped["all_schedules_valid"],
    }
    return out


def write_report(results: dict, path: str | Path,
                 meta: dict | None = None,
                 generalization: dict | None = None) -> dict:
    summary = summarize(results, meta, generalization=generalization)
    Path(path).write_text(json.dumps(summary, indent=1) + "\n")
    return summary


def emit_lines(results: dict, emit) -> None:
    """Stream the grid as ``name,us,derived`` CSV via the bench emitter."""
    for rec in results["scenarios"]:
        orc = rec["oracle"]
        emit(f"eval/{rec['name']}/oracle",
             orc["t_device_s"] / max(rec["n_graphs"], 1) * 1e6,
             f"speedup_vs_host={orc['speedup_device_vs_host']:.2f}x;"
             f"parity={orc['parity']};bb_refined={orc['bb_refined']}")
        for name in POLICY_NAMES:
            pol = rec["policies"][name]
            emit(f"eval/{rec['name']}/{name}",
                 pol["t_s"] / max(rec["n_graphs"], 1) * 1e6,
                 f"match_rate={pol['match_rate']:.3f};"
                 f"gap_mean={pol['gap_mean']:.4f};"
                 f"gap_p95={pol['gap_p95']:.4f};valid={pol['all_valid']}")
    for name in POLICY_NAMES:
        agg = results["aggregate"][name]
        emit(f"eval/aggregate/{name}", 0.0,
             f"n={agg['n']};match_rate={agg['match_rate']:.3f};"
             f"gap_mean={agg['gap_mean']:.4f};gap_p95={agg['gap_p95']:.4f}")
    emit("eval/oracle_total", 0.0,
         f"speedup_batched={results['speedup_oracle_batched']:.2f}x;"
         f"speedup_respect_vs_exact="
         f"{results['speedup_respect_vs_exact']:.1f}x;"
         f"parity={results['oracle_parity']};"
         f"all_valid={results['all_schedules_valid']}")


def check_results(results: dict) -> list[str]:
    """Hard invariants (empty list == OK): oracle parity and schedule
    validity are correctness properties, not perf — any loss is a solver
    bug regardless of machine."""
    problems = []
    if not results["oracle_parity"]:
        problems.append("oracle_parity: device oracle diverged from host "
                        "exact_dp")
    if not results["all_schedules_valid"]:
        problems.append("all_schedules_valid: a scored schedule violates "
                        "dependencies")
    for name in POLICY_NAMES:
        agg = results["aggregate"][name]
        if agg["below_refined_optimum"] > 0:
            problems.append(
                f"below_refined_optimum_{name}="
                f"{agg['below_refined_optimum']}: a schedule scored below "
                "the bb-refined true monotone optimum (oracle bug)")
    return problems


def check_hetero(results: dict) -> list[str]:
    """Hard invariants of the heterogeneous tier: everything
    :func:`check_results` enforces, plus capacity feasibility — neither
    the exact reference nor the production policy may ever emit a
    schedule with a stage over its hard ``mem_capacity`` budget."""
    problems = [f"hetero {p}" for p in check_results(results)]
    if results.get("all_capacity_feasible", True) is not True:
        problems.append(
            "all_capacity_feasible: a respect/oracle schedule places more "
            "parameter bytes on a stage than its mem_capacity budget")
    return problems


# ---------------------------------------------------------------------- #
# holding a payload to a baseline
# ---------------------------------------------------------------------- #
#: keys that carry a time, or a ratio of times, of the machine that ran
TIMING_PREFIXES = ("t_", "speedup_")


def diff_results(got, want, rtol: float = 1e-12, path: str = "") -> list[str]:
    """Every difference between two eval payloads (JSON-like trees of dicts,
    lists and scalars), timing keys (:data:`TIMING_PREFIXES`) left out at
    every level: dicts must hold the same other keys, lists the same
    length; booleans, integers and strings must be equal, floats within
    ``rtol`` relative (``|a - b| <= rtol * max(|a|, |b|)``).  Empty when the
    two agree."""
    if isinstance(want, dict) and isinstance(got, dict):
        keep = lambda d: {k for k in d if not str(k).startswith(TIMING_PREFIXES)}  # noqa: E731
        out = [f"{path}/{k}: missing" for k in sorted(keep(want) - keep(got))]
        out += [f"{path}/{k}: unexpected" for k in sorted(keep(got) - keep(want))]
        for k in sorted(keep(want) & keep(got)):
            out += diff_results(got[k], want[k], rtol, f"{path}/{k}")
        return out
    if isinstance(want, list) and isinstance(got, list):
        if len(got) != len(want):
            return [f"{path}: length {len(got)} != {len(want)}"]
        return [d for i, (a, b) in enumerate(zip(got, want))
                for d in diff_results(a, b, rtol, f"{path}[{i}]")]
    numbers = (int, float)
    if (isinstance(got, numbers) and isinstance(want, numbers)
            and not isinstance(got, bool) and not isinstance(want, bool)
            and (isinstance(got, float) or isinstance(want, float))):
        a, b = float(got), float(want)
        if a == b or abs(a - b) <= rtol * max(abs(a), abs(b)):
            return []
        return [f"{path}: {got!r} != {want!r}"]
    if type(got) is not type(want) or got != want:
        return [f"{path}: {got!r} != {want!r}"]
    return []
