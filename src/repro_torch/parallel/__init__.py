"""Data and pipeline parallelism (the reference's ``repro.parallel``, the
parts that mean something on one card or a few): a data-parallel world over
``torch.distributed`` (:mod:`.data`) and the GPipe runner that executes a
RESPECT cut (:mod:`.pipeline`).  The reference's logical-axis FSDP/TP rules
(``sharding.py``) are not ported."""

from .data import (BACKENDS, DataWorld, RankFailure, current_world, init_data_parallel,
                   rank_device, rank_slice, run_ranks)
from .pipeline import PipelineRunner

__all__ = ["BACKENDS", "DataWorld", "RankFailure", "current_world", "init_data_parallel",
           "rank_device", "rank_slice", "run_ranks", "PipelineRunner"]
