"""Meshes (``repro.launch.mesh``).

The reference's production meshes are functions returning device meshes
over a TPU fleet.  Here they return :class:`~repro_torch.parallel.sharding.
AbstractMesh` records, axis names and sizes with no devices, which is all
that resolving shardings needs:

* single-pod: (16, 16) over ("data", "model") — 256 chips;
* multi-pod:  (2, 16, 16) over ("pod", "data", "model") — 512 chips;
* pipeline:   (n_stages, data, model) over ("pipe", "data", "model");
* small test: (data, model).

:func:`single_device_mesh` builds a real ``DeviceMesh`` of one device (every
axis of size 1) on the card or the CPU, over a one-rank process group;
:func:`device_mesh` one of any shape over the initialised world (its ranks
spawned by :func:`repro_torch.parallel.data.run_ranks`), on which the step
makers of :mod:`repro_torch.launch.steps` execute sharded.
"""

from __future__ import annotations

import os
import tempfile

from ..parallel.sharding import AbstractMesh

__all__ = ["make_production_mesh", "make_pipeline_mesh", "small_test_mesh",
           "single_device_mesh", "device_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_pipeline_mesh(n_stages: int, data: int = 8, model: int = 4) -> AbstractMesh:
    """The pipeline runner's mesh (pipe axis outermost)."""
    return AbstractMesh((n_stages, data, model), ("pipe", "data", "model"))


def small_test_mesh(data: int = 2, model: int = 4) -> AbstractMesh:
    return AbstractMesh((data, model), ("data", "model"))


def single_device_mesh(device=None, axis_names: tuple = ("data", "model")):
    """A ``DeviceMesh`` of one device with every axis in ``axis_names`` of
    size 1, on the card unless ``device`` names the CPU.  Without an
    initialised process group this process becomes the one rank of a gloo
    world joined through a file store in a fresh temporary directory; a
    world of more ranks raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..device import resolve_device
    dev = resolve_device(device)
    if not dist.is_initialized():
        store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_mesh_"), "store")
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    elif dist.get_world_size() != 1:
        raise ValueError(f"a one-device mesh needs a world of 1 rank, this process is in one "
                         f"of {dist.get_world_size()}")
    if dev.type == "cuda":
        import torch
        torch.cuda.set_device(dev.index or 0)
    return init_device_mesh(dev.type, (1,) * len(axis_names), mesh_dim_names=tuple(axis_names))


def device_mesh(shape: tuple, names: tuple = ("data", "model"), device=None):
    """A ``DeviceMesh`` of ``shape`` over ``names`` on the initialised world
    of this process (rank-major: the last axis varies fastest), on the card
    unless ``device`` names the CPU.  A world whose size is not
    ``prod(shape)``, or no world, raises.  On the card over gloo (ranks
    sharing one card) the functional all-gather takes
    :func:`repro_torch.parallel.collectives.shared_card_all_gather`."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..device import resolve_device
    if len(shape) != len(names):
        raise ValueError(f"{len(shape)} axis sizes for {len(names)} names")
    if not dist.is_initialized():
        raise ValueError(f"a {tuple(shape)} mesh needs an initialised world of "
                         f"{math.prod(shape)} ranks (repro_torch.parallel.data.run_ranks)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} ranks, the world "
                         f"has {dist.get_world_size()}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        from ..parallel.collectives import use_shared_card_collectives
        use_shared_card_collectives()
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(names))
