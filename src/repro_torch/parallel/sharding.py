"""Logical-axis sharding rules (``repro.parallel.sharding``), resolved against
an abstract mesh or a ``torch.distributed`` device mesh.

Every parameter, cache entry and model input carries *logical* axis names
(the models' ``*_axes`` trees); :func:`resolve_axes` maps them onto the axes
of a mesh with the reference's rules (:data:`DEFAULT_RULES`, MaxText-style):
``batch`` over ``("pod", "data")``, ``embed`` over ``data`` (FSDP), heads,
MLP and vocabulary over ``model`` (tensor parallelism), and so on.  Two rules
decide every spec, as in the reference:

* a mesh axis that an earlier dim claimed is dropped from later dims (the
  mLSTM's ``(mlp, heads)`` both map to ``model``: the first wins);
* a dim that its mesh axes do not divide is replicated (qwen3-14b's 40
  heads on a 16-way ``model`` axis).

A mesh is either an :class:`AbstractMesh` (ordered axis names and sizes, no
devices: how the reference resolves against its 256- and 512-chip meshes)
or a ``torch.distributed.device_mesh.DeviceMesh`` with named dims.  A
resolved spec is a :class:`PartitionSpec` (one entry a tensor dim: a mesh
axis name, a tuple of names, or None), and :func:`sharding_for` pairs it
with its mesh in a :class:`NamedSharding`, whose ``placements`` on a
``DeviceMesh`` are the ``Shard(d)`` / ``Replicate()`` that
``torch.distributed.tensor.distribute_tensor`` takes.

The forwards call :func:`constrain` where the reference constrains an
activation.  On a ``DTensor`` — a step over a real ``DeviceMesh`` of
several ranks, or the dry run's program over a fake process group
(:mod:`repro_torch.launch.dryrun`) — it redistributes the tensor to the
resolved placements, as the reference's ``with_sharding_constraint`` pins a
layout for XLA (``repro_torch.models.common`` has the forwards' side:
``constrain`` at the reference's call sites, ``distribute_tree`` for a
prefill's fresh cache, ``write_seq`` for a decode step's cache write).  A
plain tensor is returned as it is without a mesh or on a mesh whose axes
all have size 1; on a ``DeviceMesh`` with a larger axis each rank keeps its
shard of it; an :class:`AbstractMesh` with a larger axis raises, since it
has no devices to hold shards.

:func:`shard_tree` is the twin of ``jax.device_put(tree, shardings)`` over a
real mesh (each rank keeps its shard of a tree every rank made alike, with
no communication), and :func:`gather_tree` returns full tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch

__all__ = [
    "DEFAULT_RULES",
    "LogicalRules",
    "AbstractMesh",
    "PartitionSpec",
    "NamedSharding",
    "axis_sizes",
    "is_axes",
    "resolve_axes",
    "sharding_for",
    "constrain",
    "placements_for",
    "is_dtensor",
    "tree_shardings",
    "data_parallel_mesh",
    "batch_sharding",
    "abstract_mesh_error",
    "shard_tree",
    "gather_tree",
    "mesh_device",
]

# logical name -> mesh axis (or tuple of axes, or None); the reference's table
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",
    "embed_nofsdp": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": "data",   # FSDP over the expert FF dim (kimi: 2 TB of
                            # expert weights need 256-way, not 16-way, sharding)
    "vocab": "model",
    "state": None,
    "conv": None,
    "layers": None,
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
    "act_seq": None,
    # flash-decode-style cache layout: shard the SEQ axis of KV caches over
    # the model axis; the dedup rule drops the later cache_heads claim
    "cache_seq": "model",
    "cache_heads": "model",
}


class _RulesState(threading.local):
    def __init__(self):
        self.rules = dict(DEFAULT_RULES)


_STATE = _RulesState()


@contextlib.contextmanager
def LogicalRules(overrides: dict[str, object]):
    """Temporarily override logical->mesh rules (this thread only)."""
    old = dict(_STATE.rules)
    _STATE.rules.update(overrides)
    try:
        yield
    finally:
        _STATE.rules = old


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, in order, with no devices."""
    axis_sizes: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for {len(self.axis_names)} names")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


class PartitionSpec(tuple):
    """One entry a tensor dim: a mesh axis name, a tuple of names, or None
    (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a resolved spec."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple | None:
        """Per mesh dim, ``Shard(d)`` for the tensor dim ``d`` that the spec
        maps onto it, else ``Replicate()``; None on an abstract mesh."""
        if isinstance(self.mesh, AbstractMesh):
            return None
        from torch.distributed.tensor import Replicate, Shard
        dim_of = {}
        for d, entry in enumerate(self.spec):
            for name in (entry if isinstance(entry, tuple) else (entry,)):
                if name is not None:
                    dim_of[name] = d
        return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                     for n in self.mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict:
    """Axis name -> size of an :class:`AbstractMesh` or a named
    ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh without mesh_dim_names cannot resolve logical axes")
    return dict(zip(names, mesh.shape))


def _mesh_axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(_mesh_axis_size(sizes, a) for a in axis)
    return sizes.get(axis, 1)


def _present(sizes: dict, axis):
    """An axis assignment filtered down to the axes this mesh has."""
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in sizes)
        return kept if kept else None
    return axis if axis in sizes else None


def resolve_axes(logical_axes, shape, mesh, rules=None) -> PartitionSpec:
    """Logical axis names (one a dim, None = replicated) -> PartitionSpec.

    A dim its mesh axes do not divide is replicated; a mesh axis claimed by
    an earlier dim is dropped from later dims."""
    rules = rules if rules is not None else _STATE.rules
    sizes = axis_sizes(mesh)
    spec = []
    used: set = set()
    for dim, name in zip(shape, logical_axes):
        axis = _present(sizes, rules.get(name)) if name is not None else None
        if axis is not None:
            members = axis if isinstance(axis, tuple) else (axis,)
            members = tuple(a for a in members if a not in used)
            axis = members if len(members) > 1 else (members[0] if members else None)
        if axis is not None and dim % _mesh_axis_size(sizes, axis) != 0:
            axis = None
        if axis is not None:
            used.update(axis if isinstance(axis, tuple) else (axis,))
        spec.append(axis)
    return PartitionSpec(*spec)


def sharding_for(logical_axes, shape, mesh, rules=None) -> NamedSharding:
    return NamedSharding(mesh, resolve_axes(logical_axes, tuple(shape), mesh, rules))


def is_dtensor(x) -> bool:
    """``x`` is a ``torch.distributed.tensor.DTensor`` (checked without
    importing it)."""
    return hasattr(x, "device_mesh") and hasattr(x, "placements")


def placements_for(logical_axes, shape, device_mesh, rules=None) -> tuple:
    """The ``Shard``/``Replicate`` placements, one per dim of a named
    ``DeviceMesh``, of a tensor of ``shape`` with ``logical_axes``."""
    return sharding_for(logical_axes, tuple(shape), device_mesh, rules).placements


class _Pin(torch.autograd.Function):
    """Redistribute a ``DTensor`` to ``placements`` and its gradient to the
    same placements, as the transpose of the reference's sharding
    constraint constrains the cotangent (a row-parallel product's partial
    sums are reduced where they arise, not carried on)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate, Shard
        mesh, want = grad.device_mesh, ctx.placements
        # a gradient split along another dim is gathered first (a direct
        # shard-to-shard move of an unevenly split dim is not exact)
        mid = tuple(Replicate() if isinstance(p, Shard) and p != w else p
                    for p, w in zip(grad.placements, want))
        if mid != tuple(grad.placements):
            grad = grad.redistribute(mesh, mid)
        return grad.redistribute(mesh, want), None


def abstract_mesh_error(mesh) -> NotImplementedError | None:
    """The error for executing on ``mesh`` where it is an
    :class:`AbstractMesh` with an axis larger than 1 (no devices to run
    on), else None."""
    if not isinstance(mesh, AbstractMesh):
        return None
    for name, size in axis_sizes(mesh).items():
        if size > 1:
            return NotImplementedError(
                f"mesh axis {name!r} has size {size} on an abstract mesh, which has no devices: "
                "execute on a DeviceMesh over a process group of that many ranks "
                "(repro_torch.launch.mesh.device_mesh)")
    return None


def constrain(x, logical_axes, mesh=None, rules=None):
    """The reference's sharding constraint by logical names.  A ``DTensor``
    is redistributed to the resolved placements on its own mesh.  A plain
    tensor is ``x`` itself without a mesh or on a mesh whose axes all have
    size 1; on a ``DeviceMesh`` with a larger axis each rank keeps its shard
    of it (every rank holds the same ``x``); an abstract mesh with a larger
    axis raises (:func:`abstract_mesh_error`)."""
    if is_dtensor(x):
        want = placements_for(logical_axes, x.shape, x.device_mesh, rules)
        if x.requires_grad and torch.is_grad_enabled():
            return _Pin.apply(x, want)
        return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)
    if mesh is None:
        return x
    err = abstract_mesh_error(mesh)
    if err is not None:
        raise err
    if all(size == 1 for size in axis_sizes(mesh).values()):
        return x
    return _shard(x, sharding_for(logical_axes, x.shape, mesh, rules))


def _shard(x, sharding: NamedSharding):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, sharding.mesh, sharding.placements, src_data_rank=None)


def shard_tree(tree, shardings):
    """``tree`` (nested dicts, or an ``OptState``, of tensors that every rank
    made alike) as ``DTensor``s at ``shardings`` (the same structure of
    :class:`NamedSharding` on a ``DeviceMesh``): each rank keeps its shard,
    with no communication.  A None leaf stays None; a ``DTensor`` leaf is
    redistributed to its sharding."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: shard_tree(v, shardings[k]) for k, v in tree.items()}
    if hasattr(tree, "tree") and hasattr(type(tree), "from_tree"):     # an OptState
        return type(tree).from_tree(shard_tree(tree.tree(), shardings.tree()))
    if is_dtensor(tree):
        pl = shardings.placements
        return tree if tuple(tree.placements) == pl else tree.redistribute(tree.device_mesh, pl)
    return _shard(tree.to(mesh_device(shardings.mesh)), shardings)


def gather_tree(tree):
    """``tree`` with every ``DTensor`` leaf as its full tensor (a collective:
    every rank of the mesh must call it); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if hasattr(tree, "tree") and hasattr(type(tree), "from_tree"):     # an OptState
        return type(tree).from_tree(gather_tree(tree.tree()))
    return tree.full_tensor() if is_dtensor(tree) else tree


def mesh_device(mesh) -> torch.device:
    """The device of this rank's shards on ``mesh`` (its current card on a
    CUDA mesh)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def data_parallel_mesh(n_devices: int | None = None, axis_name: str = "data", device=None):
    """A one-axis ``DeviceMesh`` over the data-parallel world of this process
    (:mod:`repro_torch.parallel.data`): its ``n_devices`` ranks (default:
    all).  Without an initialised world a one-rank world is made
    (:func:`repro_torch.launch.mesh.single_device_mesh`).  Asking for more
    devices than the world has raises, as the reference does."""
    from ..launch.mesh import single_device_mesh
    from .data import current_world
    world = current_world()
    if world is None:
        if n_devices not in (None, 1):
            raise ValueError(f"asked for {n_devices} devices, have 1 (no data-parallel world "
                             "is initialised)")
        return single_device_mesh(device, axis_names=(axis_name,))
    n = world.size if n_devices is None else n_devices
    if n != world.size:
        raise ValueError(f"asked for {n} devices, the data-parallel world has {world.size}")
    from torch.distributed.device_mesh import init_device_mesh
    from ..device import resolve_device
    return init_device_mesh(resolve_device(device).type, (n,), mesh_dim_names=(axis_name,))


def batch_sharding(mesh, axis_name: str = "data") -> NamedSharding:
    """A leading batch dim split over ``axis_name``."""
    return NamedSharding(mesh, PartitionSpec(axis_name))


def is_axes(x) -> bool:
    """An axes leaf: a tuple of names and Nones (the empty tuple of a
    scalar included)."""
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def tree_shardings(spec_tree, shape_tree, mesh, rules=None):
    """A tree (nested dicts) of logical-axes tuples and a tree of the same
    structure whose leaves have a ``.shape`` (tensors, ``meta`` tensors,
    :class:`~repro_torch.models.common.TensorSpec`) -> a tree of
    :class:`NamedSharding`."""
    if is_axes(spec_tree):
        return sharding_for(spec_tree, shape_tree.shape, mesh, rules)
    if set(spec_tree) != set(shape_tree):
        raise ValueError(f"axes tree keys {sorted(spec_tree)} differ from the shapes' "
                         f"{sorted(shape_tree)}")
    return {k: tree_shardings(v, shape_tree[k], mesh, rules) for k, v in spec_tree.items()}
