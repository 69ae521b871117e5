"""Collectives for ranks that share one card over gloo.

``DTensor`` issues its collectives as ``torch.ops._c10d_functional`` calls.
gloo runs ``all_reduce``, ``reduce_scatter_tensor`` and
``all_to_all_single`` of that family on CUDA tensors, and the blocking
``dist.all_gather_into_tensor``, but its functional
``all_gather_into_tensor`` on CUDA tensors kills the process (a
segmentation fault, torch 2.11 on an H100; PERF.md §6 PR 29).  So a world
whose backend is gloo and whose mesh is on the card routes that one
collective through :func:`shared_card_all_gather`: the blocking gloo
all-gather into a fresh tensor on the card, which returns the same bytes.

The route is chosen by the backend when the mesh is built
(:func:`repro_torch.launch.mesh.device_mesh` calls
:func:`use_shared_card_collectives` for gloo on CUDA; an NCCL world keeps
torch's own collective), never by catching an error.  :data:`USES` counts
each call.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

__all__ = ["USES", "shared_card_all_gather", "use_shared_card_collectives"]

#: collective name -> calls taken through this module's route
USES: collections.Counter = collections.Counter()

_LIBRARY = None


def _group(group_name):
    if isinstance(group_name, str):
        return torch._C._distributed_c10d._resolve_process_group(group_name)
    return group_name


def shared_card_all_gather(input: torch.Tensor, group_size: int, group_name) -> torch.Tensor:
    """``_c10d_functional.all_gather_into_tensor`` on a gloo group: the
    group's ranks' ``input`` stacked along dim 0, by the blocking
    ``all_gather_into_tensor`` (the result is complete when it returns)."""
    group = _group(group_name)
    if dist.get_backend(group) != "gloo":
        raise RuntimeError(f"shared_card_all_gather serves gloo groups, not "
                           f"{dist.get_backend(group)!r}")
    out = input.new_empty((group_size * input.shape[0], *input.shape[1:]))
    dist.all_gather_into_tensor(out, input.contiguous(), group=group)
    USES["all_gather_into_tensor"] += 1
    return out


def use_shared_card_collectives() -> None:
    """Route ``_c10d_functional.all_gather_into_tensor`` on CUDA tensors
    through :func:`shared_card_all_gather` in this process (for a world
    whose backend is gloo on the card; idempotent)."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = torch.library.Library("_c10d_functional", "IMPL")
        _LIBRARY.impl("all_gather_into_tensor", shared_card_all_gather, "CUDA")
