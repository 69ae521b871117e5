"""Core of the port: graph IR, cost model, embedding, pointer network,
segmentation DP and repair, batching and the scheduler facade."""

from .costmodel import (
    CAPACITY_PENALTY_S,
    SYS_FEAT_DIM,
    PipelineSystem,
    ScheduleEval,
    evaluate_schedule,
)
from .dnn_graphs import MODEL_SPECS, all_model_graphs, build_model_graph
from .embedding import embed_dim, embed_graph
from .graph import CompGraph, InvalidGraphError, validate_graph, validate_monotone
from .ptrnet import PointerNet, params_from_numpy
from .respect import RespectScheduler, ScheduleResult
from .sampler import sample_batch, sample_dag
