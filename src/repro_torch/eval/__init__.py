"""Gap-to-optimal evaluation: the port of the reference's ``repro.eval``.

* :mod:`repro_torch.eval.oracle`    — the batched exact solver
  (:class:`ExactOracle`) on the device, bit-identical to the host
  ``exact_dp``;
* :mod:`repro_torch.eval.scenarios` — the scenario grid and the shared
  graph pools, the reference's seeds and draws;
* :mod:`repro_torch.eval.runner`    — scores the RL policy, the compiler
  emulation and list scheduling against the oracle (match rate, optimality
  gap, solve-time speedup);
* :mod:`repro_torch.eval.generalization` — the large-graph tier;
* :mod:`repro_torch.eval.report`    — the ``BENCH_eval.json`` writer, the
  hard checks and :func:`diff_results`.

``python -m repro_torch.eval --smoke --check`` runs the three smoke tiers
(the CLI twin of the reference's ``benchmarks/eval_grid.py``).
"""

from .generalization import (  # noqa: F401
    GenScenario,
    check_generalization,
    generalization_grid,
    run_generalization,
)
from .oracle import ExactOracle, OracleSolution  # noqa: F401
from .report import (  # noqa: F401
    check_hetero,
    check_results,
    diff_results,
    emit_lines,
    summarize,
    summarize_generalization,
    summarize_hetero,
    write_report,
)
from .runner import MATCH_RTOL, POLICY_NAMES, run_grid, run_scenario  # noqa: F401
from .scenarios import (  # noqa: F401
    HETERO_FAMILIES,
    INGEST_ARCHS,
    SYNTH_FAMILIES,
    Scenario,
    hetero_grid,
    hetero_system,
    ingest_scenarios,
    layered_dag,
    scenario_grid,
    synthetic_dag,
    table1_scenarios,
    traffic_pool,
    traffic_synthetic_pool,
)
