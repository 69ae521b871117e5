"""The rho mapping (paper Eq. 2): node sequence -> stage assignment.

The policy emits an *order* pi over nodes; the deployable schedule is
``rho(pi)``, the optimal contiguous segmentation of that order under the
pipeline cost model (:func:`repro_torch.core.exact.exact_dp` restricted to
the given order).  ``rho`` of the exact solver's own sequence reproduces its
assignment.  The serving path runs the device twin,
:func:`repro_torch.core.segment.rho_dp`; this host version is the oracle.
A copy of the reference's ``repro.core.rho``.
"""

from __future__ import annotations

import numpy as np

from .costmodel import PipelineSystem
from .exact import exact_dp
from .graph import CompGraph

__all__ = ["rho"]


def rho(
    graph: CompGraph,
    order: np.ndarray,
    n_stages: int,
    system: PipelineSystem | None = None,
) -> np.ndarray:
    """Map a node sequence to a per-node stage assignment."""
    order = np.asarray(order, dtype=np.int64)
    if sorted(order.tolist()) != list(range(graph.n)):
        raise ValueError("order must be a permutation of the nodes")
    assign, _ = exact_dp(graph, n_stages, system, order=order)
    return assign
