"""Labelled synthetic-DAG dataset for RL training (the reference's
``repro.data.dags``).

The dataset is drawn once, labelled exactly (host branch and bound, or the
batched DP on the device) and cached as ``.npz`` under the reference's key
of (count, |V|, stages, seed, solver, budget, system), so the two packages
share one cache file.  :meth:`LabeledDagDataset.batch` then samples
deterministic labelled packs from it, nodes padded to the power-of-two
bucket as the sampler's stream pads them.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from ..core.batching import PaddedGraphBatch, bucket_for
from ..core.costmodel import PipelineSystem
from ..core.embedding import embed_graph
from ..core.exact import exact_bb, order_from_assignment
from ..core.sampler import sample_batch

__all__ = ["LabeledDagDataset"]


class LabeledDagDataset:
    def __init__(self, count: int = 4096, n: int = 30, n_stages: int = 4, seed: int = 0,
                 label_method: str = "bb", bb_budget_s: float = 0.05, max_deg: int = 6,
                 system: PipelineSystem | None = None,
                 cache_dir: str | Path = "artifacts/dag_cache", device=None):
        self.count, self.n, self.n_stages = count, n, n_stages
        self.seed, self.label_method = seed, label_method
        self.bb_budget_s, self.max_deg = bb_budget_s, max_deg
        self.system = (system or PipelineSystem(n_stages)).with_stages(n_stages)
        self.cache_dir = Path(cache_dir)
        self.device = device      # where the "dp" labeller runs (None: the card)
        self._data = None

    def _cache_path(self) -> Path:
        key = json.dumps({
            "count": self.count, "n": self.n, "k": self.n_stages,
            "seed": self.seed, "method": self.label_method,
            "budget": self.bb_budget_s,
            "sys": [self.system.compute_rate, self.system.link_bw,
                    self.system.cache_bytes],
        }, sort_keys=True)
        h = hashlib.sha256(key.encode()).hexdigest()[:16]
        return self.cache_dir / f"dags_{h}.npz"

    def build(self, verbose: bool = False) -> dict:
        """Draw and label the dataset, or read it from the cache."""
        path = self._cache_path()
        if path.exists():
            self._data = dict(np.load(path))
            return self._data
        rng = np.random.default_rng(self.seed)
        feats, pmat, fl, pb, ob, la, lo = [], [], [], [], [], [], []
        done = 0
        while done < self.count:
            chunk = sample_batch(rng, min(64, self.count - done), n=self.n)
            for g in chunk:
                feats.append(embed_graph(g, self.max_deg))
                pmat.append(g.parent_matrix(self.max_deg))
                fl.append(g.flops)
                pb.append(g.param_bytes)
                ob.append(g.out_bytes)
            if self.label_method == "bb":
                for g in chunk:
                    a, _ = exact_bb(g, self.n_stages, self.system,
                                    time_budget_s=self.bb_budget_s)
                    la.append(a)
                    lo.append(order_from_assignment(a))
            else:
                from ..core.rl import label_graphs
                ca, co = label_graphs(chunk, self.n_stages, self.system,
                                      max_deg=self.max_deg, label_method="dp",
                                      device=self.device)
                la.extend(ca)
                lo.extend(co)
            done += len(chunk)
            if verbose:
                print(f"  labeled {done}/{self.count}")
        self._data = {
            "feats": np.stack(feats).astype(np.float32),
            "parent_mat": np.stack(pmat).astype(np.int32),
            "flops": np.stack(fl).astype(np.float32),
            "param_bytes": np.stack(pb).astype(np.float32),
            "out_bytes": np.stack(ob).astype(np.float32),
            "label_assign": np.stack(la).astype(np.int32),
            "label_order": np.stack(lo).astype(np.int32),
        }
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        np.savez(path, **self._data)
        return self._data

    def batch(self, step: int, batch_size: int) -> PaddedGraphBatch:
        """Deterministic labelled pack of CPU tensors for a training step:
        ``batch_size`` graphs drawn by ``default_rng((seed, step))``, nodes
        padded from |V| to the power-of-two bucket (zeros, -1 parents)."""
        if self._data is None:
            self.build()
        d = self._data
        rng = np.random.default_rng((self.seed, step))
        idx = rng.integers(0, len(d["feats"]), size=batch_size)
        n = d["feats"].shape[1]
        bucket_n = bucket_for(n)

        def zpad(a, fill=0):
            a = a[idx]
            if bucket_n != n:
                a = np.pad(a, [(0, 0), (0, bucket_n - n)] + [(0, 0)] * (a.ndim - 2),
                           constant_values=fill)
            return torch.from_numpy(np.ascontiguousarray(a))

        return PaddedGraphBatch(
            feats=zpad(d["feats"]), parent_mat=zpad(d["parent_mat"], fill=-1),
            flops=zpad(d["flops"]), param_bytes=zpad(d["param_bytes"]),
            out_bytes=zpad(d["out_bytes"]),
            n_valid=torch.full((len(idx),), n, dtype=torch.int32),
            label_assign=zpad(d["label_assign"]), label_order=zpad(d["label_order"]),
            label_stages=self.n_stages)
