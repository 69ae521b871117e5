"""Data and pipeline parallelism (the reference's ``repro.parallel``): a
data-parallel world over ``torch.distributed`` (:mod:`.data`), the GPipe
runner that executes a RESPECT cut (:mod:`.pipeline`), and the logical-axis
FSDP/TP rules resolved against a mesh (:mod:`.sharding`; execution stays on
one device)."""

from .data import (BACKENDS, DataWorld, RankFailure, current_world, init_data_parallel,
                   rank_device, rank_slice, run_ranks)
from .pipeline import PipelineRunner
from .sharding import (DEFAULT_RULES, AbstractMesh, LogicalRules, NamedSharding, PartitionSpec,
                       batch_sharding, constrain, data_parallel_mesh, resolve_axes, sharding_for,
                       tree_shardings)

__all__ = ["BACKENDS", "DataWorld", "RankFailure", "current_world", "init_data_parallel",
           "rank_device", "rank_slice", "run_ranks", "PipelineRunner"]
