"""Coarsen a per-operation record program into a small CompGraph: the port's
copy of the reference's ``repro.ingest.coarsen``, line for line, so the same
records give the same CompGraph and ``content_hash``.

The trace emits one record per compute operation — hundreds for even
a smoke model.  Schedulers want tens of nodes.  This pass contracts the
instruction DAG into at most ``max_nodes`` fusion-region super-nodes while
preserving DAG-ness (no merge ever creates a cycle) and conserving cost
mass:

* ``flops`` and ``param_bytes`` of a super-node are plain sums over its
  members;
* ``out_bytes`` counts only members whose output crosses the region
  boundary (a consumer outside the group, or no consumers at all) — the
  internal tensors of a fused region never transit the pipeline.

Merge safety invariants (each proved in the module tests):

1. chain merge — edge (u, v) with out-degree(u) == 1: every path out of u
   goes through v, so the direct edge is the only u~>v path;
2. safe edge merge — edge (u, v) with no intermediate w on another u~>v
   path (checked against the live transitive-reachability matrix);
3. incomparable merge — neither u~>v nor v~>u: contracting cannot close a
   cycle (a cycle would need a path between them).

The pass is fully deterministic (stable sorts, index tie-breaks): the same
records always produce the bit-identical CompGraph, which is what makes
schedule caching and the bit-stability CI check possible.

After contraction, transitive reduction drops parent edges already implied
through another parent, and any node still above the scheduler's
``max_deg`` in-degree packing limit gets its cheapest (now pairwise
incomparable) parents merged until it fits.
"""

from __future__ import annotations

import numpy as np

from ..core.graph import CompGraph
from .records import HloProgram

__all__ = ["coarsen_program"]


class _Contract:
    """Mutable contraction state over the record DAG."""

    def __init__(self, prog: HloProgram):
        recs = prog.instructions
        n = len(recs)
        name2i = {r.name: i for i, r in enumerate(recs)}
        self.n0 = n
        self.alive = np.ones(n, dtype=bool)
        self.flops = np.array([r.flops for r in recs], dtype=np.float64)
        self.param = np.array([r.param_bytes for r in recs], dtype=np.float64)
        self.out = np.array([r.out_bytes for r in recs], dtype=np.float64)
        self.names = [r.name for r in recs]
        self.members: list[list[int]] = [[i] for i in range(n)]
        self.par: list[set] = [set() for _ in range(n)]
        self.child: list[set] = [set() for _ in range(n)]
        for v, r in enumerate(recs):
            for o in r.operands:
                u = name2i[o]
                self.par[v].add(u)
                self.child[u].add(v)
        # original per-record values, for boundary out_bytes and
        # representative naming at emit time
        self.orig_children = [sorted(c) for c in self.child]
        self.orig_out = self.out.copy()
        self.member_flops = self.flops.copy()
        self._reach: np.ndarray | None = None
        self._freeze_scales()

    # -------------------------------------------------------------- #
    @property
    def n_alive(self) -> int:
        return int(self.alive.sum())

    def work(self, i: int) -> float:
        """Normalized merge score: cheap nodes merge first."""
        return (self.flops[i] / max(self._fsum, 1.0)
                + (self.param[i] + self.out[i]) / max(self._bsum, 1.0))

    def _freeze_scales(self):
        self._fsum = float(self.flops.sum())
        self._bsum = float((self.param + self.out).sum())

    # -------------------------------------------------------------- #
    def reach(self) -> np.ndarray:
        """Strict transitive reachability over live nodes (lazy build).

        Built in Kahn order of the CURRENT contracted graph — after chain
        merges a node's parent can carry a larger index, so record index
        order is no longer topological."""
        if self._reach is None:
            n = self.n0
            r = np.zeros((n, n), dtype=bool)
            indeg = {int(v): len(self.par[v])
                     for v in np.flatnonzero(self.alive)}
            stack = sorted((v for v, d in indeg.items() if d == 0),
                           reverse=True)
            seen = 0
            while stack:
                u = stack.pop()
                seen += 1
                for c in sorted(self.child[u], reverse=True):
                    r[:, c] |= r[:, u]
                    r[u, c] = True
                    indeg[c] -= 1
                    if indeg[c] == 0:
                        stack.append(c)
            assert seen == self.n_alive, "contracted graph has a cycle"
            self._reach = r
        return self._reach

    def comparable(self, u: int, v: int) -> bool:
        r = self.reach()
        return bool(r[u, v] or r[v, u])

    def edge_is_safe(self, u: int, v: int) -> bool:
        """True iff the direct edge is the only u~>v path (no intermediate
        w with u~>w~>v)."""
        r = self.reach()
        return not bool(np.any(r[u] & r[:, v]))

    # -------------------------------------------------------------- #
    def merge(self, u: int, v: int) -> int:
        """Contract v into u (caller guarantees safety).  Returns u."""
        assert self.alive[u] and self.alive[v] and u != v
        self.flops[u] += self.flops[v]
        self.param[u] += self.param[v]
        self.out[u] += self.out[v]
        self.members[u].extend(self.members[v])
        for p in self.par[v]:
            self.child[p].discard(v)
            if p != u:
                self.par[u].add(p)
                self.child[p].add(u)
        for c in self.child[v]:
            self.par[c].discard(v)
            if c != u:
                self.child[u].add(c)
                self.par[c].add(u)
        self.par[u].discard(v)
        self.child[u].discard(v)
        self.par[u].discard(u)
        self.child[u].discard(u)
        self.par[v] = set()
        self.child[v] = set()
        self.alive[v] = False
        if self._reach is not None:
            r = self._reach
            r[:, u] |= r[:, v]
            r[u, :] |= r[v, :]
            r[u, u] = False
            # close the closure: every ancestor of the merged node now
            # reaches every descendant of it
            anc = r[:, u].copy()
            if anc.any():
                r[anc] |= r[u]
            r[v, :] = False
            r[:, v] = False
        return u

    # -------------------------------------------------------------- #
    def contract_chains(self, target: int):
        """Merge edges (u, v) with out-degree(u) == 1 — always safe (every
        path out of u goes through v), no reachability needed.

        Work-budgeted and cheapest-first: a merge is only taken while the
        combined node stays under ~2x the average work of a ``target``-way
        partition, so a transformer's layer chain contracts into balanced
        pieces instead of one mega-node per sweep order.  The budget-free
        balanced pass (:meth:`contract_to`) finishes the job."""
        budget = 4.0 / max(target, 1)   # work() is normalized: total == 2
        while self.n_alive > target:
            cands = sorted(
                ((self.work(u) + self.work(v), u, v)
                 for u in map(int, np.flatnonzero(self.alive))
                 if len(self.child[u]) == 1
                 for v in self.child[u]
                 if self.work(u) + self.work(v) <= budget),
                key=lambda t: (t[0], t[1], t[2]))
            merged_any = False
            for _, u, v in cands:
                if self.n_alive <= target:
                    return
                if not (self.alive[u] and self.alive[v]):
                    continue
                if len(self.child[u]) != 1 or v not in self.child[u]:
                    continue
                if self.work(u) + self.work(v) > budget:
                    continue
                self.merge(u, v)
                merged_any = True
            if not merged_any:
                return

    def contract_to(self, max_nodes: int):
        """Greedy safe merges until at most ``max_nodes`` live nodes."""
        while self.n_alive > max_nodes:
            live = [int(i) for i in np.flatnonzero(self.alive)]
            # candidate edges, cheapest combined work first
            edges = sorted(
                ((self.work(u) + self.work(v), u, v)
                 for u in live for v in self.child[u]),
                key=lambda t: (t[0], t[1], t[2]))
            merged = False
            for _, u, v in edges:
                if self.edge_is_safe(u, v):
                    self.merge(u, v)
                    merged = True
                    break
            if merged:
                continue
            # no safe edge: merge the cheapest incomparable pair (always
            # safe); prefer pairs sharing a parent or child
            best = None
            for u in live:
                for nbrs in (self.par[u], self.child[u]):
                    for w in nbrs:
                        group = self.child[w] if nbrs is self.par[u] \
                            else self.par[w]
                        for v in group:
                            if v <= u or not self.alive[v]:
                                continue
                            if self.comparable(u, v):
                                continue
                            s = (self.work(u) + self.work(v), u, v)
                            if best is None or s < best:
                                best = s
            if best is None:
                for ui, u in enumerate(live):
                    for v in live[ui + 1:]:
                        if self.comparable(u, v):
                            continue
                        s = (self.work(u) + self.work(v), u, v)
                        if best is None or s < best:
                            best = s
            if best is None:
                # total order: consecutive-by-ancestor-count pairs have no
                # intermediate, so their (direct) edge is safe
                order = sorted(live,
                               key=lambda i: int(self.reach()[:, i].sum()))
                u, v = order[0], order[1]
                self.merge(u, v)
            else:
                self.merge(best[1], best[2])

    # -------------------------------------------------------------- #
    def reduce_degree(self, max_deg: int):
        """Transitive reduction on parent lists, then merge incomparable
        parents of any node still over the in-degree packing limit."""
        r = self.reach()
        for v in np.flatnonzero(self.alive):
            v = int(v)
            redundant = [p for p in self.par[v]
                         if any(r[p, q] for q in self.par[v] if q != p)]
            for p in redundant:
                self.par[v].discard(p)
                self.child[p].discard(v)
        # after reduction, a node's parents are pairwise incomparable —
        # merging any two is an incomparable merge (safe); re-reduce after
        # each merge because new reachability can re-imply edges.
        while True:
            over = [int(v) for v in np.flatnonzero(self.alive)
                    if len(self.par[v]) > max_deg]
            if not over:
                return
            v = over[0]
            ps = sorted(self.par[v], key=lambda p: (self.work(p), p))
            a, b = None, None
            for i in range(len(ps)):
                for j in range(i + 1, len(ps)):
                    if not self.comparable(ps[i], ps[j]):
                        a, b = ps[i], ps[j]
                        break
                if a is not None:
                    break
            if a is None:        # parents all comparable post-reduction?
                a, b = ps[0], ps[1]     # pragma: no cover - defensive
            self.merge(min(a, b), max(a, b))
            r = self.reach()
            for w in np.flatnonzero(self.alive):
                w = int(w)
                redundant = [p for p in self.par[w]
                             if any(r[p, q] for q in self.par[w] if q != p)]
                for p in redundant:
                    self.par[w].discard(p)
                    self.child[p].discard(w)

    # -------------------------------------------------------------- #
    def emit(self, model_name: str) -> CompGraph:
        live = [int(i) for i in np.flatnonzero(self.alive)]
        group_of = {}
        for g in live:
            for m in self.members[g]:
                group_of[m] = g
        idx = {g: k for k, g in enumerate(live)}
        # boundary out_bytes: members whose output leaves the group
        out_b = np.zeros(len(live))
        for k, g in enumerate(live):
            gset = set(self.members[g])
            for m in self.members[g]:
                cs = self.orig_children[m]
                if not cs or any(c not in gset for c in cs):
                    out_b[k] += self.orig_out[m]
        names = []
        for g in live:
            rep = max(self.members[g],
                      key=lambda m: (self.member_flops[m], -m))
            extra = len(self.members[g]) - 1
            names.append(self.names[rep] + (f"+{extra}" if extra else ""))
        edges = [(idx[u], idx[v]) for u in live for v in self.child[u]]
        return CompGraph.from_edges(
            n=len(live), edges=sorted(edges),
            flops=self.flops[live], param_bytes=self.param[live],
            out_bytes=out_b, names=names, model_name=model_name)


def coarsen_program(prog: HloProgram, max_nodes: int, *,
                    max_deg: int = 6,
                    model_name: str = "ingested") -> CompGraph:
    """Contract an :class:`HloProgram` into a CompGraph with at most
    ``max_nodes`` nodes and in-degree at most ``max_deg``."""
    if not prog.instructions:
        raise ValueError("cannot coarsen an empty HLO program")
    if max_nodes < 2:
        raise ValueError("max_nodes must be >= 2")
    c = _Contract(prog)
    if c.n_alive > max_nodes:
        c.contract_chains(max_nodes)
    if c.n_alive > max_nodes:
        c.contract_to(max_nodes)
    c.reduce_degree(max_deg)
    return c.emit(model_name)
