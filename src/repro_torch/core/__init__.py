"""Core of the port: graph IR, cost model, embedding, the threefry PRNG,
pointer network, segmentation DP and repair, the host solvers, batching,
the scheduler facade, and the pod-scale partitioner (``core.partitioner``:
the LM zoo's block graphs cut into pipeline stages)."""

from .batching import greedy_order, sample_order
from .costmodel import (
    CAPACITY_PENALTY_S,
    EDGETPU,
    SYS_FEAT_DIM,
    PipelineSystem,
    PodSystem,
    ScheduleEval,
    evaluate_schedule,
)
from .dnn_graphs import MODEL_SPECS, all_model_graphs, build_model_graph
from .embedding import embed_dim, embed_graph
from .exact import brute_force_monotone, exact_bb, exact_dp, order_from_assignment
from .graph import CompGraph, InvalidGraphError, validate_graph, validate_monotone
from .heuristic import compiler_partition, heuristic_schedule_many, list_schedule
from .prng import PRNGKey
from .ptrnet import PointerNet, init_params, params_from_numpy, params_to_numpy
from .respect import RespectScheduler, ScheduleResult
from .rho import rho
from .sampler import DagSampler, prefetch, sample_batch, sample_dag
