"""Data and pipeline parallelism (the reference's ``repro.parallel``): a
data-parallel world over ``torch.distributed`` (:mod:`.data`), the GPipe
runner that executes a RESPECT cut (:mod:`.pipeline`), the logical-axis
FSDP/TP rules resolved against a mesh (:mod:`.sharding`: ``shard_tree`` and
``gather_tree`` place and gather trees on a ``DeviceMesh`` of several
ranks), and the functional all-gather of ranks sharing one card over gloo
(:mod:`.collectives`)."""

from .data import (BACKENDS, DataWorld, RankFailure, current_world, init_data_parallel,
                   rank_device, rank_slice, run_ranks)
from .pipeline import PipelineRunner
from .sharding import (DEFAULT_RULES, AbstractMesh, LogicalRules, NamedSharding, PartitionSpec,
                       batch_sharding, constrain, data_parallel_mesh, gather_tree, resolve_axes,
                       shard_tree, sharding_for, tree_shardings)

__all__ = ["BACKENDS", "DataWorld", "RankFailure", "current_world", "init_data_parallel",
           "rank_device", "rank_slice", "run_ranks", "PipelineRunner"]
