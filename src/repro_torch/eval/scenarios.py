"""Scenario grid: the families × sizes × stage-counts the eval runner sweeps.

The paper's generalizability argument (PAPER.md, Tables II-III, Fig. 5)
rests on three graph populations: small synthetic DAGs (where the exact
solver is tractable and RESPECT is trained), the ten Table-I DNN graphs
(where it must generalize), and the serving-traffic mix.  This module is
the port's copy of the reference's ``repro.eval.scenarios``: the same
seeds, draws and lists, over the port's own ``sample_dag``,
``all_model_graphs``, ``CompGraph`` and ``PipelineSystem``, so the
gap-to-optimal runner (:mod:`repro_torch.eval.runner`) scores the very
graphs the reference scores.

Synthetic families (all seeded, all with ``max_in_degree <= 6`` so they
pack under the repo-wide ``max_deg``):

* ``chain``   — pure backbone chains (the Table-I DNNs are
  chain-dominated; on a chain every monotone assignment is contiguous,
  so the segmentation DP is provably the monotone optimum);
* ``layered`` — nodes arranged in levels with edges only between
  adjacent levels (inception-style parallel modules);
* ``branchy`` — low chain fraction, high merge degree (the adversarial
  end of the training distribution).

The fourth population is **ingested** graphs (family ``ingest``): real
zoo architectures traced through :mod:`repro_torch.ingest` (a shapes-only
torch trace -> per-operation records -> coarsened CompGraph).  The port's
trace is its own (XLA fuses, the port's records do not), so its graphs are
not the reference's; the scenario lists are.  Ingest scenarios join the
FULL grid only; the smoke grid (the checked-in ``BENCH_eval.json``
baseline) holds none.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.costmodel import PipelineSystem
from ..core.dnn_graphs import all_model_graphs
from ..core.graph import CompGraph
from ..core.sampler import sample_dag

__all__ = [
    "SYNTH_FAMILIES",
    "HETERO_FAMILIES",
    "INGEST_ARCHS",
    "INGEST_SEQ_LEN",
    "Scenario",
    "synthetic_dag",
    "layered_dag",
    "hetero_system",
    "scenario_grid",
    "hetero_grid",
    "table1_scenarios",
    "ingest_scenarios",
    "traffic_synthetic_pool",
    "traffic_pool",
]

SYNTH_FAMILIES = ("chain", "layered", "branchy")

# graph pools for these families are a mixed draw over SYNTH_FAMILIES; what
# varies is the SYSTEM: per-stage cost constants (hetero) and additionally a
# hard per-stage parameter budget (memcap).  They live in their own grid
# (:func:`hetero_grid`) so the uniform smoke aggregate — and the absolute
# quality ratchets pinned against it — stays untouched.
HETERO_FAMILIES = ("hetero", "memcap")

# the ingest scenario pair: one attention architecture, one SSM — both
# full configs sit far above the 8 MB stage SRAM, so pipelining (and
# hence the gap-to-optimal comparison) is non-degenerate
INGEST_ARCHS = ("whisper-tiny", "xlstm-350m")
INGEST_SEQ_LEN = 64


def layered_dag(rng: np.random.Generator, n: int) -> CompGraph:
    """A level-structured DAG: every node at level l > 0 draws 1-3
    parents from level l - 1 (deg capped at 4 so merge nodes stay within
    the packed parent-matrix width)."""
    if n < 3:
        raise ValueError("need at least 3 nodes")
    width = int(rng.integers(2, max(3, n // 4) + 1))
    level_of: list[int] = []
    level = 0
    while len(level_of) < n:
        size = 1 if level == 0 else int(rng.integers(1, width + 1))
        size = min(size, n - len(level_of))
        level_of.extend([level] * size)
        level += 1
    levels = np.asarray(level_of)
    parents: list[list[int]] = [[] for _ in range(n)]
    for v in range(1, n):
        prev = np.flatnonzero(levels == levels[v] - 1)
        k = int(rng.integers(1, min(4, len(prev)) + 1))
        ps = rng.choice(prev, size=k, replace=False)
        parents[v] = sorted(int(u) for u in ps)
    # attributes: same lognormal CNN-like profile as sample_dag
    depth_pos = np.arange(n) / max(n - 1, 1)
    out_bytes = np.exp(rng.normal(0.0, 0.6, n)) * 3e5 * (1.0 - 0.85 * depth_pos)
    param_bytes = np.exp(rng.normal(0.0, 0.9, n)) * 3e5 * (0.3 + 1.7 * depth_pos)
    param_bytes[rng.random(n) < 0.3] = 0.0
    flops = param_bytes * rng.uniform(30, 120, n) + out_bytes * rng.uniform(1, 8, n)
    return CompGraph(parents=parents, flops=flops, param_bytes=param_bytes,
                     out_bytes=out_bytes, model_name=f"layered_n{n}")


def synthetic_dag(family: str, rng: np.random.Generator, n: int) -> CompGraph:
    """Draw one graph from a named synthetic family."""
    if family == "chain":
        return sample_dag(rng, n=n, deg=1, chain_frac_range=(1.0, 1.0))
    if family == "layered":
        return layered_dag(rng, n)
    if family == "branchy":
        deg = int(rng.integers(3, 5))
        return sample_dag(rng, n=n, deg=min(deg, n - 2),
                          chain_frac_range=(0.3, 0.6))
    raise ValueError(f"unknown family {family!r}; one of {SYNTH_FAMILIES}")


def hetero_system(n_stages: int, seed: int) -> PipelineSystem:
    """A seeded heterogeneous Edge-TPU chain: per-stage ``compute_rate``,
    ``link_bw`` and ``cache_bytes`` are the uniform defaults times an
    independent ``2**U(-1, 1)`` multiplier (each stage between half and
    double the stock constant — the mixed-SKU / shared-hub regime).
    ``compute_eff`` stays scalar on purpose: only the ``rate * eff``
    product matters to the cost model, and keeping one field scalar
    exercises the mixed scalar/tuple system path end to end."""
    rng = np.random.default_rng(seed)
    base = PipelineSystem(n_stages=n_stages)

    def jitter(scalar: float) -> tuple[float, ...]:
        return tuple(float(scalar * 2.0 ** rng.uniform(-1.0, 1.0))
                     for _ in range(n_stages))

    return PipelineSystem(
        n_stages=n_stages,
        compute_rate=jitter(float(base.compute_rate)),
        link_bw=jitter(float(base.link_bw)),
        cache_bytes=jitter(float(base.cache_bytes)),
    )


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One cell of the eval grid: a seeded graph population × a stage
    count.  ``build()`` is deterministic, so every consumer (runner,
    benches, tests) sees the same graphs for the same scenario."""

    name: str
    family: str              # chain | layered | branchy | dnn | traffic
    #                        # | ingest | hetero | memcap
    n_stages: int
    sizes: tuple[int, ...] = ()
    graphs_per_size: int = 0
    seed: int = 0
    smoke: bool = False      # traffic/ingest family: pool / model config
    archs: tuple[str, ...] = ()   # ingest family: zoo architectures
    n_nodes: int = 0              # ingest family: coarsening budget
    system: PipelineSystem | None = None  # hetero/memcap: per-stage profile
    memcap_frac: float = 0.0      # memcap family: per-stage budget as a
    #                             # fraction of the pool's largest total
    #                             # param bytes (0 = unconstrained)

    def build(self) -> list[CompGraph]:
        if self.family == "dnn":
            return list(all_model_graphs().values())
        if self.family == "traffic":
            rng = np.random.default_rng(self.seed)
            pool, _, _ = traffic_pool(self.smoke, rng)
            return pool
        if self.family == "ingest":
            # deferred import: ingestion pulls in the model zoo, which the
            # synthetic grid never needs
            from ..ingest import ingest_model
            return [ingest_model(a, n_nodes=self.n_nodes, smoke=self.smoke,
                                 seq_len=INGEST_SEQ_LEN).graph
                    for a in self.archs]
        if self.family in HETERO_FAMILIES:
            # the hetero axis varies the SYSTEM, not the graphs: a mixed
            # draw over all synthetic families keeps the pool comparable
            # to the uniform grid's population
            rng = np.random.default_rng(self.seed)
            return [synthetic_dag(fam, rng, n)
                    for fam in SYNTH_FAMILIES
                    for n in self.sizes
                    for _ in range(self.graphs_per_size)]
        rng = np.random.default_rng(self.seed)
        return [synthetic_dag(self.family, rng, n)
                for n in self.sizes for _ in range(self.graphs_per_size)]

    def resolve_system(self, graphs: list[CompGraph]) -> PipelineSystem:
        """The :class:`PipelineSystem` this scenario scores under.

        Uniform scenarios (``system is None``, no ``memcap_frac``) resolve
        to the stock scalar system — exactly what the runner always built.
        ``memcap_frac > 0`` stamps a seeded per-stage ``mem_capacity``
        vector resolved against the graph POOL: the base budget is
        ``max(frac * total_params, total_params / k + max_node_param,
        1.3 * max_node_param)`` over all pool graphs, which guarantees a
        capacity-feasible contiguous split exists for EVERY graph under
        ANY node order (greedy filling to ``total/k`` overshoots by at
        most one node), so the hard ``all_capacity_feasible`` flag is a
        solver property, not a scenario lottery.  Per-stage multipliers
        ``2**U(0, 0.5)`` sit on top (only >= 1, preserving the
        guarantee)."""
        system = ((self.system or PipelineSystem(n_stages=self.n_stages))
                  .with_stages(self.n_stages))
        if self.memcap_frac <= 0.0:
            return system
        k = self.n_stages
        total = max(float(g.param_bytes.sum()) for g in graphs)
        max_node = max(float(g.param_bytes.max()) for g in graphs)
        base = max(self.memcap_frac * total,
                   total / k + max_node,
                   1.3 * max_node)
        rng = np.random.default_rng(self.seed + 1)
        caps = tuple(float(base * 2.0 ** rng.uniform(0.0, 0.5))
                     for _ in range(k))
        return dataclasses.replace(system, mem_capacity=caps)


def table1_scenarios(stage_counts=(4, 5, 6)) -> list[Scenario]:
    """The ten Table-I DNN graphs at the paper's stage counts."""
    return [Scenario(name=f"dnn/k{k}", family="dnn", n_stages=k)
            for k in stage_counts]


def ingest_scenarios(smoke: bool = False,
                     stage_counts: tuple[int, ...] = (4,),
                     n_nodes: int = 12,
                     archs: tuple[str, ...] = INGEST_ARCHS
                     ) -> list[Scenario]:
    """Real ingested zoo models at an oracle-tractable coarsening budget.

    ``smoke`` selects the smoke model configs (sub-second traces, but the
    graphs sit below the per-stage overhead floor, so single-stage wins
    and the comparison is degenerate); the default full configs are the
    regime the bench and the full grid score."""
    return [Scenario(name=f"ingest/k{k}", family="ingest", n_stages=k,
                     smoke=smoke, archs=archs, n_nodes=n_nodes)
            for k in stage_counts]


def scenario_grid(smoke: bool = False,
                  stage_counts: tuple[int, ...] | None = None,
                  table1_stages: tuple[int, ...] | None = None) -> list[Scenario]:
    """The full sweep: synthetic families (|V| ~= 5-30) × stage counts
    (2-8) × the ten Table-I graphs × the serving-traffic pool.

    ``smoke`` shrinks sizes/counts to the CI configuration (the one the
    checked-in ``BENCH_eval.json`` pins) without dropping any family or
    the Table-I coverage.
    """
    if stage_counts is None:
        stage_counts = (2, 4, 8) if smoke else (2, 3, 4, 6, 8)
    if table1_stages is None:
        table1_stages = (4,) if smoke else (4, 5, 6)
    sizes = (6, 10, 14, 20) if smoke else (5, 8, 12, 16, 20, 24, 30)
    per_size = 3 if smoke else 4
    out: list[Scenario] = []
    for family in SYNTH_FAMILIES:
        for k in stage_counts:
            out.append(Scenario(
                name=f"{family}/k{k}", family=family, n_stages=k,
                sizes=sizes, graphs_per_size=per_size,
                seed=hash_seed(family, k)))
    out.extend(table1_scenarios(table1_stages))
    out.append(Scenario(name="traffic/k4", family="traffic", n_stages=4,
                        seed=0, smoke=smoke))
    if not smoke:
        # full grid only: real ingested models cost seconds of jit
        # tracing per architecture, and the checked-in smoke baseline
        # (BENCH_eval.json) must not depend on the installed XLA's HLO
        # output.  The ingest surface has its own guarded artifact
        # (benchmarks/ingest_bench.py -> BENCH_ingest.json).
        out.extend(ingest_scenarios(smoke=False))
    return out


def hetero_grid(smoke: bool = False) -> list[Scenario]:
    """The heterogeneous-system tier: per-stage cost profiles (``hetero``)
    and hard per-stage memory budgets on top (``memcap``), over a mixed
    synthetic pool.  A SEPARATE grid from :func:`scenario_grid` so the
    uniform smoke aggregate — and the absolute ratchet floors CI pins
    against it — is byte-identical to the pre-hetero artifact; the
    report writer folds this tier in under ``hetero_*`` keys.
    """
    stage_counts = (2, 4) if smoke else (2, 4, 6, 8)
    sizes = (6, 10, 14) if smoke else (5, 8, 12, 16, 20)
    per_size = 2 if smoke else 3
    out: list[Scenario] = []
    for k in stage_counts:
        out.append(Scenario(
            name=f"hetero/k{k}", family="hetero", n_stages=k,
            sizes=sizes, graphs_per_size=per_size,
            seed=hash_seed("hetero", k),
            system=hetero_system(k, seed=hash_seed("hetero-sys", k))))
        out.append(Scenario(
            name=f"memcap/k{k}", family="memcap", n_stages=k,
            sizes=sizes, graphs_per_size=per_size,
            seed=hash_seed("memcap", k),
            system=hetero_system(k, seed=hash_seed("memcap-sys", k)),
            memcap_frac=0.6))
    # one capacity-only cell: uniform cost constants, hard budgets only —
    # isolates the capacity machinery from the per-stage cost machinery
    out.append(Scenario(
        name="memcap/uniform_k4", family="memcap", n_stages=4,
        sizes=sizes, graphs_per_size=per_size,
        seed=hash_seed("memcap-uniform", 4), memcap_frac=0.5))
    return out


def hash_seed(family: str, k: int) -> int:
    """Deterministic per-cell seed (crc32: PYTHONHASHSEED-independent)."""
    import zlib
    return zlib.crc32(f"{family}/k{k}".encode())


# --------------------------------------------------------------------- #
# shared pools: the serving benches score EXACTLY these graphs
# --------------------------------------------------------------------- #
def traffic_synthetic_pool(rng: np.random.Generator,
                           n_graphs: int) -> list[CompGraph]:
    """The mixed-size synthetic serving pool (|V| in [8, 40], deg in
    [2, 4]) — the sampling sequence ``benchmarks/serve_traffic_bench.py``
    has always used, now shared with the eval grid's traffic scenario."""
    sizes = rng.integers(8, 41, size=n_graphs)
    degs = rng.integers(2, 5, size=n_graphs)
    return [sample_dag(rng, n=int(n), deg=int(d))
            for n, d in zip(sizes, degs)]


def traffic_pool(smoke: bool, rng: np.random.Generator):
    """(pool, n_synthetic, n_models): the full serving-bench request pool
    — synthetic mix plus, in full (non-smoke) mode, the ten Table-I
    model graphs."""
    n_synth = 12 if smoke else 16
    pool = traffic_synthetic_pool(rng, n_synth)
    n_models = 0
    if not smoke:
        models = list(all_model_graphs().values())
        pool += models
        n_models = len(models)
    return pool, n_synth, n_models
