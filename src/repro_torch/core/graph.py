"""Computational-graph IR for RESPECT scheduling (host numpy).

A :class:`CompGraph` is a DAG whose nodes carry the three attributes the
cost model needs — ``flops``, ``param_bytes`` and ``out_bytes`` — with node
indices already in topological order.  Same semantics as the reference's
``repro.core.graph``; :meth:`CompGraph.content_hash` gives the same hex
digest for the same graph, so schedule caches of the two packages agree on
keys.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

__all__ = [
    "CompGraph",
    "InvalidGraphError",
    "asap_levels",
    "validate_graph",
    "validate_monotone",
    "hash_op_name",
]


class InvalidGraphError(ValueError):
    """A graph failed structural or attribute validation: empty, NaN,
    infinite or negative costs, mismatched attribute lengths, or topology
    that is no longer a DAG in topological order."""


def hash_op_name(name: str, modulus: int = 1 << 16) -> int:
    """Stable integer id for an operator name (paper: "node IDs are unique
    integers generated by hashing all the operator names")."""
    digest = hashlib.sha256(name.encode("utf-8")).digest()
    return int.from_bytes(digest[:4], "little") % modulus


@dataclasses.dataclass
class CompGraph:
    """A DAG of ``n`` operators.

    ``parents[v]`` lists the producers feeding node ``v``; every parent index
    is smaller than its child's, so the node order is topological.
    """

    parents: list[list[int]]
    flops: np.ndarray
    param_bytes: np.ndarray
    out_bytes: np.ndarray
    names: list[str] | None = None
    model_name: str = "graph"

    def __post_init__(self):
        n = len(self.parents)
        self.flops = np.asarray(self.flops, dtype=np.float64)
        self.param_bytes = np.asarray(self.param_bytes, dtype=np.float64)
        self.out_bytes = np.asarray(self.out_bytes, dtype=np.float64)
        if not (len(self.flops) == len(self.param_bytes) == len(self.out_bytes) == n):
            raise ValueError("attribute arrays must have one entry per node")
        if self.names is None:
            self.names = [f"op_{i}" for i in range(n)]
        for v, ps in enumerate(self.parents):
            for u in ps:
                if not 0 <= u < v:
                    raise ValueError(f"node order is not topological: edge {u}->{v}")
        self._children: list[list[int]] | None = None
        self._levels: np.ndarray | None = None

    @property
    def n(self) -> int:
        return len(self.parents)

    @property
    def children(self) -> list[list[int]]:
        if self._children is None:
            ch: list[list[int]] = [[] for _ in range(self.n)]
            for v, ps in enumerate(self.parents):
                for u in ps:
                    ch[u].append(v)
            self._children = ch
        return self._children

    def edges(self):
        for v, ps in enumerate(self.parents):
            for u in ps:
                yield (u, v)

    @property
    def num_edges(self) -> int:
        return sum(len(p) for p in self.parents)

    @property
    def max_in_degree(self) -> int:
        return max((len(p) for p in self.parents), default=0)

    @property
    def max_out_degree(self) -> int:
        return max((len(c) for c in self.children), default=0)

    @property
    def levels(self) -> np.ndarray:
        """ASAP topological levels (paper's absolute coordinates)."""
        if self._levels is None:
            self._levels = asap_levels(self.parents)
        return self._levels

    @property
    def depth(self) -> int:
        return int(self.levels.max()) + 1 if self.n else 0

    @classmethod
    def from_edges(cls, n: int, edges: list[tuple[int, int]], flops, param_bytes, out_bytes,
                   names=None, model_name: str = "graph") -> "CompGraph":
        """Build from an arbitrary edge list, relabelling the nodes into the
        reference's topological order (a stack-driven Kahn sort)."""
        indeg = np.zeros(n, dtype=np.int64)
        ch: list[list[int]] = [[] for _ in range(n)]
        for u, v in edges:
            if u == v:
                raise ValueError("self edge")
            ch[u].append(v)
            indeg[v] += 1
        order: list[int] = []
        stack = [v for v in range(n) if indeg[v] == 0]
        while stack:
            u = stack.pop()
            order.append(u)
            for w in ch[u]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    stack.append(w)
        if len(order) != n:
            raise ValueError("graph has a cycle")
        pos = {old: new for new, old in enumerate(order)}
        parents: list[list[int]] = [[] for _ in range(n)]
        for u, v in edges:
            parents[pos[v]].append(pos[u])
        names = [names[i] for i in order] if names is not None else None
        return cls(parents, np.asarray(flops)[order], np.asarray(param_bytes)[order],
                   np.asarray(out_bytes)[order], names, model_name)

    def parent_matrix(self, max_deg: int) -> np.ndarray:
        """(n, max_deg) int32 matrix of parent indices, padded with -1."""
        m = np.full((self.n, max_deg), -1, dtype=np.int32)
        for v, ps in enumerate(self.parents):
            if len(ps) > max_deg:
                raise ValueError(f"node {v} has in-degree {len(ps)} > {max_deg}")
            m[v, : len(ps)] = ps
        return m

    def child_matrix(self, max_deg: int) -> np.ndarray:
        """(n, max_deg) int32 matrix of child indices in ascending order,
        padded with -1 — the packed dual of :meth:`parent_matrix`."""
        m = np.full((self.n, max_deg), -1, dtype=np.int32)
        for u, cs in enumerate(self.children):
            if len(cs) > max_deg:
                raise ValueError(f"node {u} has out-degree {len(cs)} > {max_deg}")
            m[u, : len(cs)] = cs
        return m

    def ancestor_matrix(self) -> np.ndarray:
        """(n, n) bool, ``[v, u]`` True iff ``u`` is an ancestor of ``v`` or
        ``v`` itself."""
        m = np.zeros((self.n, self.n), dtype=bool)
        for v, ps in enumerate(self.parents):
            m[v, v] = True
            for u in ps:
                m[v] |= m[u]
        return m

    def op_ids(self, modulus: int = 1 << 16) -> np.ndarray:
        return np.array([hash_op_name(nm, modulus) for nm in self.names], np.int64)

    def content_hash(self) -> str:
        """Stable digest of everything a scheduler's output depends on:
        topology, the three cost attributes and the operator names.  The
        key of the schedule cache."""
        h = hashlib.sha256()
        h.update(np.int64(self.n).tobytes())
        for ps in self.parents:
            h.update(np.asarray(ps, dtype=np.int64).tobytes())
            h.update(b"|")
        for arr in (self.flops, self.param_bytes, self.out_bytes):
            h.update(np.ascontiguousarray(arr, dtype=np.float64).tobytes())
        h.update("\x00".join(self.names).encode("utf-8"))
        return h.hexdigest()


    def stats(self) -> dict:
        return {
            "model": self.model_name,
            "V": self.n,
            "E": self.num_edges,
            "deg": self.max_in_degree,
            "depth": self.depth,
            "param_MB": float(self.param_bytes.sum() / 2**20),
            "flops_G": float(self.flops.sum() / 1e9),
        }


def asap_levels(parents: list[list[int]]) -> np.ndarray:
    """As-Soon-As-Possible level of every node (sources at level 0)."""
    n = len(parents)
    lv = np.zeros(n, dtype=np.int64)
    for v in range(n):
        if parents[v]:
            lv[v] = 1 + max(lv[u] for u in parents[v])
    return lv


def validate_graph(graph: CompGraph) -> None:
    """Reject malformed graphs with :class:`InvalidGraphError`: non-empty,
    one finite non-negative value per node for each cost attribute, names
    aligned, and ``parents`` still a topologically-ordered DAG."""
    if not isinstance(graph, CompGraph):
        raise InvalidGraphError(f"expected a CompGraph, got {type(graph).__name__}")
    n = len(graph.parents)
    if n == 0:
        raise InvalidGraphError("empty graph (0 nodes)")
    for attr in ("flops", "param_bytes", "out_bytes"):
        arr = np.asarray(getattr(graph, attr))
        if arr.shape != (n,):
            raise InvalidGraphError(f"{attr} has shape {arr.shape}, expected ({n},)")
        if not np.isfinite(arr).all():
            raise InvalidGraphError(f"{attr} contains NaN/inf values")
        if (arr < 0).any():
            raise InvalidGraphError(f"{attr} contains negative costs")
    if graph.names is None or len(graph.names) != n:
        raise InvalidGraphError("names missing or not one per node")
    for v, ps in enumerate(graph.parents):
        for u in ps:
            if not 0 <= u < v:
                raise InvalidGraphError(
                    f"topology is not a topologically-ordered DAG: "
                    f"edge {u}->{v} (cycle or mutated parents)")


def validate_monotone(graph: CompGraph, assign: np.ndarray, n_stages: int) -> bool:
    """A schedule is deployable iff stage(u) <= stage(v) along every edge and
    every stage index is inside [0, n_stages)."""
    assign = np.asarray(assign)
    if assign.shape != (graph.n,):
        return False
    if assign.min(initial=0) < 0 or assign.max(initial=0) >= n_stages:
        return False
    for u, v in graph.edges():
        if assign[u] > assign[v]:
            return False
    return True
