"""RespectScheduler — the deployable facade (paper Fig. 1a, steps 1-4).

``schedule_many(graphs, n_stages)`` is the serving path (and
``schedule_model(arch, n_stages)`` the same path for a real model's
ingested graph): cache misses are
grouped into power-of-two size buckets and each bucket runs embed ->
pointer-network decode -> segmentation DP on the device and repair on the
host (:mod:`repro_torch.core.batching`).  A lock-guarded content-hash LRU
serves repeated graphs; every result holds copies, never the cache's
arrays.  :meth:`RespectScheduler.fallback_schedule_many` runs the same
engine with seeded weights, the serving ladder's middle rung, and never
touches the cache.  Checkpoints use the reference's directory format
(:func:`repro_torch.checkpoint.save_pytree`); legacy ``.npz`` dumps load.

Entry points run on CUDA unless given ``device``; without CUDA they raise
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np

from ..device import resolve_device
from .batching import BucketedDecoder
from .costmodel import PipelineSystem
from .embedding import embed_dim
from .graph import CompGraph
from .prng import PRNGKey
from .ptrnet import PointerNet, params_from_numpy, params_to_numpy

__all__ = ["RespectScheduler", "ScheduleResult"]


class ScheduleResult(dict):
    """assignment + provenance; behaves like a dict for serialization."""

    @property
    def assignment(self) -> np.ndarray:
        return self["assignment"]


class RespectScheduler:
    def __init__(self, net: PointerNet, *, device=None, max_deg: int = 6,
                 cache_size: int = 1024, decode_impl: str | None = None,
                 decode_bf16: bool = False):
        self.device = resolve_device(device)
        self.net = net.to(self.device)
        #: release manifest when the weights came from a verified release
        self.release: dict | None = None
        self.max_deg = max_deg
        # decode_impl and decode_bf16 choose how the pointing loop runs (see
        # BucketedDecoder)
        self._decoder = BucketedDecoder(self.device, max_deg=max_deg, decode_impl=decode_impl,
                                        decode_bf16=decode_bf16)
        self._cache: OrderedDict = OrderedDict()
        self._cache_size = cache_size
        # one lock guards the cache and the counters; device work runs outside it
        self._cache_lock = threading.Lock()
        self.cache_hits = 0
        self.cache_misses = 0
        # seeded weights of the degraded rung (fallback_schedule_many), built
        # on first use and kept; never mixed with self.net
        self._fallback_net: PointerNet | None = None

    @classmethod
    def init(cls, seed: int = 0, hidden: int = 256, max_deg: int = 6, *, device=None,
             **kw) -> "RespectScheduler":
        """Seeded untrained agent: the reference's ``init_params(PRNGKey(seed))``
        weights bit for bit, so its schedules are the reference's."""
        net = PointerNet.init(embed_dim(max_deg), hidden, key=PRNGKey(seed))
        return cls(net, device=device, max_deg=max_deg, **kw)

    def save(self, path: str | Path) -> None:
        """Write the weights in the checkpoint directory format (manifest +
        raw leaf buffers, atomic), readable by the reference's loaders."""
        from ..checkpoint import save_pytree
        save_pytree(params_to_numpy(self.net), path)

    @classmethod
    def load(cls, path: str | Path, *, device=None, **kw) -> "RespectScheduler":
        """Load a checkpoint directory, or a legacy flat ``.npz`` whose keys
        are ``["enc"]["wx"]``-style paths."""
        from ..checkpoint import is_checkpoint_dir, load_pytree_dict
        path = Path(path)
        if is_checkpoint_dir(path):
            return cls(params_from_numpy(load_pytree_dict(path)), device=device, **kw)
        params: dict = {}
        with np.load(path) as data:
            for key in data.files:
                parts = [p.strip("'\"") for p in key.strip("[]").split("][")]
                d = params
                for p in parts[:-1]:
                    d = d.setdefault(p, {})
                d[parts[-1]] = data[key]
        return cls(params_from_numpy(params), device=device, **kw)

    @classmethod
    def from_release(cls, path: str | Path | None = None, fallback_seed: int = 0, *,
                     device=None, **kw) -> "RespectScheduler":
        """Load the trained release (``checkpoints/respect-v*``, verified),
        else warn and fall back to seeded weights.  A given ``path`` must
        verify: corruption raises, and so does a release trained without the
        infeasible-parent mask (the port always decodes with it)."""
        from ..checkpoint.release import ReleaseError, load_release_params, warn_no_release
        device = resolve_device(device)
        params, manifest = load_release_params(path)
        if params is None:
            warn_no_release("RespectScheduler.from_release")
            return cls.init(seed=fallback_seed, device=device, **kw)
        cfg = manifest.get("config", {})
        if not cfg.get("mask_infeasible", True):
            raise ReleaseError("release config has mask_infeasible=false; the port decodes "
                               "with the infeasible-parent mask only")
        kw.setdefault("max_deg", cfg.get("max_deg", 6))
        sched = cls(params_from_numpy(params), device=device, **kw)
        sched.release = manifest
        return sched

    @property
    def hidden(self) -> int:
        return self.net.hidden

    def fallback_schedule_many(self, graphs: list[CompGraph], n_stages: int,
                               system: PipelineSystem | None = None,
                               fallback_seed: int = 0) -> list[ScheduleResult]:
        """Schedule with seeded weights at the loaded policy's width instead
        of the loaded ones, through the same engine: the serving ladder's
        middle rung.  The weights are built on the first call and kept, so
        that call's ``fallback_seed`` sticks (as in the reference).  Results
        are stamped ``served_by="fallback"`` and never touch the cache or
        its counters."""
        system = (system or PipelineSystem(n_stages)).with_stages(n_stages)
        if self._fallback_net is None:
            self._fallback_net = PointerNet.init(embed_dim(self.max_deg), self.hidden,
                                                 key=PRNGKey(fallback_seed)).to(self.device)
        fused = self._decoder.fused_schedules(self._fallback_net, graphs, n_stages, system)
        out = []
        for g, (order, assignment) in zip(graphs, fused):
            res = self._result_from({"assignment": assignment, "order": order}, n_stages,
                                    g.model_name, False)
            res["served_by"] = "fallback"
            out.append(res)
        return out

    def order(self, graph: CompGraph) -> np.ndarray:
        """Raw greedy decode of one graph (no rho/repair, no cache)."""
        return self._decoder.greedy_orders(self.net, [graph])[0]

    def schedule(self, graph: CompGraph, n_stages: int, system: PipelineSystem | None = None,
                 return_timing: bool = False, use_cache: bool = True) -> ScheduleResult:
        """One graph through :meth:`schedule_many` (same engine, same cache)."""
        t0 = time.perf_counter()
        res = self.schedule_many([graph], n_stages, system, return_timing=return_timing,
                                 use_cache=use_cache)[0]
        if return_timing:
            res["t_total_s"] = time.perf_counter() - t0
        return res

    def schedule_model(self, arch: str, n_stages: int = 4, *, n_nodes: int = 32,
                       smoke: bool = True, kind: str = "prefill",
                       system: PipelineSystem | None = None,
                       use_cache: bool = True) -> ScheduleResult:
        """Schedule a REAL registry model end to end: trace it on the meta
        device, record its operations, coarsen to at most ``n_nodes``
        super-nodes (:mod:`repro_torch.ingest`), then run the CompGraph
        through :meth:`schedule` — the same engine, the same cache.  The
        ingest report rides along under ``result["ingest"]``."""
        from ..ingest import ingest_model   # deferred: pulls in the model zoo
        res = ingest_model(arch, n_nodes=n_nodes, smoke=smoke, kind=kind, max_deg=self.max_deg)
        out = self.schedule(res.graph, n_stages, system, use_cache=use_cache)
        out["ingest"] = dict(res.report)
        return out

    def load_kernels(self) -> None:
        """On a CUDA scheduler, build and load the kernels the miss path
        launches, so that no request pays for ``nvcc``; a no-op on the CPU."""
        if self.device.type == "cuda":
            from ..kernels.ptr.ops import load_kernels
            load_kernels()

    def _cache_key(self, graph: CompGraph, n_stages: int, system: PipelineSystem) -> tuple:
        return (graph.content_hash(), n_stages, system)

    def clear_cache(self) -> None:
        """Empty the schedule cache and reset the counters."""
        with self._cache_lock:
            self._cache.clear()
            self.cache_hits = 0
            self.cache_misses = 0

    def cache_stats(self) -> dict:
        """Consistent snapshot of the cache counters."""
        with self._cache_lock:
            return {"hits": self.cache_hits, "misses": self.cache_misses,
                    "size": len(self._cache)}

    @staticmethod
    def _result_from(entry: dict, n_stages: int, model: str, cache_hit: bool) -> ScheduleResult:
        return ScheduleResult(assignment=entry["assignment"].copy(),
                              order=entry["order"].copy(), n_stages=n_stages, model=model,
                              cache_hit=cache_hit, served_by="policy")

    def schedule_many(self, graphs: list[CompGraph], n_stages: int,
                      system: PipelineSystem | None = None, return_timing: bool = False,
                      use_cache: bool = True) -> list[ScheduleResult]:
        """Schedule a batch of graphs; results aligned with ``graphs``.
        Misses run the bucketed miss path; repeats (within this call or
        across calls, by content hash) are served from the cache."""
        system = (system or PipelineSystem(n_stages)).with_stages(n_stages)
        t0 = time.perf_counter()
        results: list[ScheduleResult | None] = [None] * len(graphs)
        misses: list[int] = []
        seen: dict[tuple, list[int]] = {}
        keys = ([self._cache_key(g, n_stages, system) for g in graphs]
                if use_cache else [None] * len(graphs))
        hit_fills: list[tuple[int, dict]] = []
        with self._cache_lock:
            for i, key in enumerate(keys):
                if use_cache and key in self._cache:
                    self._cache.move_to_end(key)
                    self.cache_hits += 1
                    hit_fills.append((i, self._cache[key]))
                elif use_cache and key in seen:
                    seen[key].append(i)
                else:
                    if use_cache:
                        seen[key] = [i]
                    misses.append(i)
        for i, entry in hit_fills:
            results[i] = self._result_from(entry, n_stages, graphs[i].model_name, True)

        t_fused = 0.0
        if misses:
            td = time.perf_counter()
            fused = self._decoder.fused_schedules(self.net, [graphs[i] for i in misses],
                                                  n_stages, system)
            t_fused = time.perf_counter() - td
            entries = {i: {"assignment": a, "order": o} for i, (o, a) in zip(misses, fused)}
            dup_fills: list[tuple[int, dict]] = []
            with self._cache_lock:
                if use_cache:
                    self.cache_misses += len(misses)
                    for i, entry in entries.items():
                        self._cache[keys[i]] = entry
                        for j in seen.get(keys[i], [])[1:]:
                            self.cache_hits += 1
                            dup_fills.append((j, entry))
                        while len(self._cache) > self._cache_size:
                            self._cache.popitem(last=False)
            for i, entry in entries.items():
                results[i] = self._result_from(entry, n_stages, graphs[i].model_name, False)
            for j, entry in dup_fills:
                results[j] = self._result_from(entry, n_stages, graphs[j].model_name, True)

        if return_timing:
            t_total = time.perf_counter() - t0
            for r in results:
                r["t_fused_batch_s"] = t_fused
                r["t_total_batch_s"] = t_total
        return results
