"""DNN computational-graph embedding (paper §III-A).

Per node: the ASAP level, the parents' levels and ids, the node's hashed
id, and its memory — as a float32 row of width ``embed_dim(max_deg)``.  The
rows written are columns ``0 .. 2 + 2*max_deg``; the last column stays zero
(the released policy's ``w_in`` has ``embed_dim(6) = 16`` rows).  Same
bytes as the reference's ``repro.core.embedding.embed_graph``.
"""

from __future__ import annotations

import numpy as np

from .graph import CompGraph

__all__ = ["embed_graph", "embed_dim", "PAD_PARENT_ID"]

PAD_PARENT_ID = -1.0
_MEM_SCALE = 1.0e6
_ID_MODULUS = 1 << 16


def embed_dim(max_deg: int = 6) -> int:
    return 2 + 2 * max_deg + 2


def embed_graph(graph: CompGraph, max_deg: int = 6,
                mem_scale: float = _MEM_SCALE) -> np.ndarray:
    """Embed a graph into the paper's per-node feature rows (float32)."""
    n = graph.n
    levels = graph.levels.astype(np.float64)
    denom = max(float(levels.max()), 1.0)
    ids = graph.op_ids(_ID_MODULUS).astype(np.float64) / _ID_MODULUS

    feat = np.zeros((n, embed_dim(max_deg)), dtype=np.float32)
    feat[:, 0] = levels / denom
    for v, ps in enumerate(graph.parents):
        if len(ps) > max_deg:
            raise ValueError(f"in-degree {len(ps)} exceeds max_deg={max_deg}")
        for j in range(max_deg):
            if j < len(ps):
                feat[v, 1 + j] = levels[ps[j]] / denom
                feat[v, 1 + max_deg + j] = ids[ps[j]]
            else:
                feat[v, 1 + j] = 0.0
                feat[v, 1 + max_deg + j] = PAD_PARENT_ID
    feat[:, 1 + 2 * max_deg] = ids
    mem = (graph.param_bytes + graph.out_bytes) / mem_scale
    feat[:, 2 + 2 * max_deg] = np.log1p(mem)
    return feat
