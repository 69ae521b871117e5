"""Step makers of the LM zoo (the reference's ``repro.launch``): the
single-device train step, the sharded step makers over a mesh (executed by
the ranks of a real world, ``device_mesh``; rank bodies in ``ranks``), the
meshes, and the multi-pod dry run (``dryrun``: per-device memory, cost and
collectives of every arch x shape x mesh cell over a fake 256/512-rank
mesh; ``cost``, ``roofline`` at the H100's published peaks,
``perfprobe``)."""

from .cost import COLLECTIVE_KINDS, StepCost
from .dryrun import MICROBATCHES, lower_cell, trace_step, train_config
from .mesh import (device_mesh, make_pipeline_mesh, make_production_mesh, single_device_mesh,
                   small_test_mesh)
from .roofline import HW, MODEL_FLOPS_NOTE, Roofline, collective_seconds, roofline_from_cost
from .steps import (batch_shardings, cache_shardings, make_decode_step, make_optimizer,
                    make_prefill_step, make_train_fn, make_train_step, named_leaves,
                    opt_shardings, param_shardings, value_and_grad)

__all__ = ["make_optimizer", "make_train_fn", "named_leaves", "value_and_grad",
           "param_shardings", "batch_shardings", "cache_shardings", "opt_shardings",
           "make_train_step", "make_prefill_step", "make_decode_step",
           "make_production_mesh", "make_pipeline_mesh", "small_test_mesh",
           "single_device_mesh", "device_mesh", "StepCost", "COLLECTIVE_KINDS", "HW", "Roofline",
           "roofline_from_cost", "collective_seconds", "MODEL_FLOPS_NOTE", "MICROBATCHES",
           "train_config", "lower_cell", "trace_step"]
