"""Step makers of the LM zoo (the reference's ``repro.launch``): the
single-device train step, the sharded step makers over a mesh (one device
executes), and the meshes."""

from .mesh import make_pipeline_mesh, make_production_mesh, single_device_mesh, small_test_mesh
from .steps import (batch_shardings, cache_shardings, make_decode_step, make_optimizer,
                    make_prefill_step, make_train_fn, make_train_step, named_leaves,
                    opt_shardings, param_shardings, value_and_grad)

__all__ = ["make_optimizer", "make_train_fn", "named_leaves", "value_and_grad",
           "param_shardings", "batch_shardings", "cache_shardings", "opt_shardings",
           "make_train_step", "make_prefill_step", "make_decode_step",
           "make_production_mesh", "make_pipeline_mesh", "small_test_mesh",
           "single_device_mesh"]
