"""RESPECT at pod scale: transformer-block graphs -> pipeline stages (the
reference's ``repro.core.partitioner``).

``model_graph`` lowers any of the ten architecture configs into the
:class:`CompGraph` the scheduler consumes — one node per block, plus the
embedding and the head, a chain — dressed with analytic per-step flops,
parameter bytes and inter-block activation bytes at a (shape, mesh slice);
``partition_model`` cuts it into ``n_stages`` pipeline stages of a
:func:`repro_torch.core.costmodel.PodSystem` with one of the solvers: the
exact DP, the compiler-style heuristic, list scheduling, or a
:class:`RespectScheduler` (B1 on the card: the pod system is uniform).
MoE blocks carry far more parameter bytes than their share of the flops, so
a parameter-balancing cut and a flop-balancing cut disagree there.
"""

from __future__ import annotations

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig
from .costmodel import PipelineSystem, PodSystem, evaluate_schedule
from .exact import exact_dp
from .graph import CompGraph
from .heuristic import compiler_partition, list_schedule

__all__ = ["model_graph", "partition_model", "stage_assignment_to_layers"]


def _block_costs(cfg: ModelConfig, tok: str, seq: int, batch: int):
    """(flops, param_bytes) of one block for one forward pass."""
    d = cfg.d_model
    tokens = batch * seq
    dh = cfg.resolved_head_dim
    if tok in ("a", "A"):
        if cfg.attention == "mla":
            p_attn = (d * cfg.q_lora_rank
                      + cfg.q_lora_rank * cfg.n_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
                      + d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                      + cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
                      + cfg.n_heads * cfg.v_head_dim * d)
        else:
            p_attn = d * cfg.n_heads * dh + 2 * d * cfg.n_kv_heads * dh \
                + cfg.n_heads * dh * d
        f_attn = 2 * tokens * p_attn + 4 * tokens * seq * cfg.n_heads * dh / 2
        if cfg.moe is not None and tok != "c":
            m = cfg.moe
            p_mlp = m.n_experts * 3 * d * m.d_ff_expert
            f_mlp = 2 * tokens * m.top_k * 3 * d * m.d_ff_expert
            p_mlp += m.n_shared_experts * 3 * d * m.d_ff_expert
            f_mlp += 2 * tokens * m.n_shared_experts * 3 * d * m.d_ff_expert
        else:
            p_mlp = 3 * d * cfg.d_ff
            f_mlp = 2 * tokens * p_mlp
        return f_attn + f_mlp, (p_attn + p_mlp) * 2.0   # bf16 bytes
    if tok == "m":
        s = cfg.ssm
        d_inner = s.expand * d
        nh = d_inner // s.head_dim
        p = d * (2 * d_inner + 2 * s.n_groups * s.state_dim + nh) + d_inner * d
        f = 2 * tokens * p + tokens * s.state_dim * d_inner * 4
        return f, p * 2.0
    if tok == "x":
        d_inner = cfg.ssm.expand * d
        p = d * 2 * d_inner + 3 * d_inner * d_inner + d_inner * d
        f = 2 * tokens * p
        return f, p * 2.0
    if tok == "s":
        p = 4 * d * d + d * d
        f = 2 * tokens * p
        return f, p * 2.0
    raise ValueError(tok)


def model_graph(cfg: ModelConfig, shape: ShapeConfig, mesh_slice: int = 1) -> CompGraph:
    """One node per block (+ embed/head).  ``mesh_slice`` divides per-node
    flops/bytes by the intra-stage parallelism (data x model shards), so
    stage costs reflect what one pipeline stage's chips execute."""
    seq, batch = shape.seq_len, shape.global_batch
    d = cfg.d_model
    act_bytes = batch * seq * d * 2.0 / mesh_slice

    names, flops, params, outb, parents = [], [], [], [], []

    def add(name, f, p, parent):
        names.append(name)
        flops.append(f / mesh_slice)
        params.append(p / mesh_slice)
        outb.append(act_bytes)
        parents.append([parent] if parent is not None else [])
        return len(names) - 1

    prev = add("embed", 2.0 * batch * seq * d, cfg.vocab_size * d * 2.0, None)
    shared_done = False
    for i, tok in enumerate(cfg.pattern()):
        f, p = _block_costs(cfg, tok, seq, batch)
        if tok == "A":
            # shared weights live once; later call sites carry no bytes
            p_eff = p if not shared_done else 0.0
            shared_done = True
        else:
            p_eff = p
        prev = add(f"{tok}{i}", f, p_eff, prev)
    head_p = 0.0 if cfg.tie_embeddings else cfg.vocab_size * d * 2.0
    add("head", 2.0 * batch * seq * cfg.vocab_size / 8, head_p, prev)

    return CompGraph(parents=parents, flops=np.array(flops),
                     param_bytes=np.array(params), out_bytes=np.array(outb),
                     names=names, model_name=f"{cfg.name}@{shape.name}")


def partition_model(cfg: ModelConfig, shape: ShapeConfig, n_stages: int,
                    method: str = "exact", scheduler=None, mesh_slice: int = 1,
                    system: PipelineSystem | None = None):
    """Partition a model into pipeline stages.

    method: "exact" | "compiler" | "list" | "respect" (needs ``scheduler``,
    a :class:`RespectScheduler`).  Returns (assignment per graph node,
    ScheduleEval, CompGraph)."""
    g = model_graph(cfg, shape, mesh_slice)
    system = (system or PodSystem(n_stages)).with_stages(n_stages)
    if method == "exact":
        assign, _ = exact_dp(g, n_stages, system)
    elif method == "compiler":
        assign = compiler_partition(g, n_stages, system)
    elif method == "list":
        assign = list_schedule(g, n_stages, system)
    elif method == "respect":
        if scheduler is None:
            raise ValueError("method='respect' needs a RespectScheduler")
        assign = scheduler.schedule(g, n_stages, system).assignment
    else:
        raise ValueError(method)
    return assign, evaluate_schedule(g, assign, system), g


def stage_assignment_to_layers(cfg: ModelConfig, assign) -> list[list[int]]:
    """Graph-node assignment -> per-stage block (layer) index lists; node 0
    is the embedding and the last node the head (pinned to first/last)."""
    n_stages = int(np.max(assign)) + 1
    stages: list[list[int]] = [[] for _ in range(n_stages)]
    for node, st in enumerate(assign):
        if node == 0 or node == len(assign) - 1:
            continue
        stages[int(st)].append(node - 1)     # block index
    return stages
