"""Synthetic DAG sampler: the paper's random computational graphs.

A dominant backbone chain, skip and branch edges that create merge nodes up
to the requested max in-degree, and lognormal byte attributes shaped like
CNN profiles.  From the same ``numpy`` generator state the draws — and so
the graphs — are those of the reference's ``repro.core.sampler``.
:class:`DagSampler` is its reproducible (seed, counter) stream, and
:func:`prefetch` moves any iterator onto a background thread.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from .graph import CompGraph

__all__ = ["sample_dag", "sample_batch", "DagSampler", "prefetch"]


def sample_dag(rng: np.random.Generator, n: int = 30, deg: int = 2,
               chain_frac_range: tuple[float, float] = (0.55, 0.95)) -> CompGraph:
    """Draw one synthetic computational graph whose max in-degree is ``deg``."""
    if n < 3:
        raise ValueError("need at least 3 nodes")
    if deg < 1:
        raise ValueError("deg >= 1")

    chain_frac = rng.uniform(*chain_frac_range)
    parents: list[list[int]] = [[] for _ in range(n)]
    indeg = np.zeros(n, dtype=np.int64)

    for v in range(1, n):
        if rng.random() < chain_frac or v == 1:
            parents[v].append(v - 1)
        else:
            parents[v].append(int(rng.integers(0, v)))
        indeg[v] = 1

    # skip edges create merge nodes; one node is forced to in-degree deg
    n_extra = int(rng.integers(n // 6, n // 2 + 1))
    candidates = list(range(2, n))
    rng.shuffle(candidates)
    forced = None
    for v in candidates:
        if forced is None and v >= deg:
            forced = v
            want = deg
        else:
            want = int(rng.integers(1, deg + 1))
            if n_extra <= 0:
                continue
        while indeg[v] < want:
            u = int(rng.integers(0, v))
            if u in parents[v]:
                if indeg[v] >= v:
                    break
                continue
            parents[v].append(u)
            indeg[v] += 1
            n_extra -= 1

    depth_pos = np.arange(n) / max(n - 1, 1)
    out_bytes = np.exp(rng.normal(0.0, 0.6, n)) * 3e5 * (1.0 - 0.85 * depth_pos)
    param_bytes = np.exp(rng.normal(0.0, 0.9, n)) * 3e5 * (0.3 + 1.7 * depth_pos)
    param_free = rng.random(n) < 0.3
    param_bytes[param_free] = 0.0
    flops = param_bytes * rng.uniform(30, 120, n) + out_bytes * rng.uniform(1, 8, n)

    for ps in parents:
        ps.sort()
    return CompGraph(parents=parents, flops=flops, param_bytes=param_bytes,
                     out_bytes=out_bytes, names=[f"op_{i}" for i in range(n)],
                     model_name=f"synthetic_n{n}_deg{deg}")


def sample_batch(rng: np.random.Generator, batch: int, n=30,
                 degs=(2, 3, 4, 5, 6)) -> list[CompGraph]:
    """A batch with the paper's uniform mixture over deg(V) in {2..6}; ``n``
    is an int or an inclusive ``(lo, hi)`` range drawn per graph."""
    return [sample_dag(rng, n=_draw_n(rng, n), deg=int(rng.choice(degs)))
            for _ in range(batch)]


def _draw_n(rng: np.random.Generator, n) -> int:
    if isinstance(n, (tuple, list)):
        return int(rng.integers(int(n[0]), int(n[1]) + 1))
    return int(n)


class DagSampler:
    """Stateful sampler with a deterministic stream: draw ``c`` comes from
    ``default_rng((seed, c))``, so a restored :meth:`state` resumes the same
    graphs.  ``n`` is an int or an inclusive ``(lo, hi)`` size range.

    ``label_cache_dir`` is handed to the labeller of the packed batches:
    the stream is deterministic, so a second epoch reads its exact labels
    from disk.  The packed batches are labelled on ``device`` (the card
    unless the caller names one) and come back as CPU tensors."""

    def __init__(self, seed: int = 0, n=30, degs=(2, 3, 4, 5, 6), label_cache_dir=None):
        self.seed = seed
        self.n = tuple(n) if isinstance(n, (tuple, list)) else n
        self.degs = tuple(degs)
        self.label_cache_dir = label_cache_dir
        self._count = 0

    def next_batch(self, batch: int) -> list[CompGraph]:
        rng = np.random.default_rng((self.seed, self._count))
        self._count += 1
        return sample_batch(rng, batch, n=self.n, degs=self.degs)

    def next_packed_batch(self, batch: int, n_stages: int, system=None, max_deg: int = 6,
                          label_method: str = "dp", pad: bool | str = "auto", device=None):
        """Sample, embed and exactly label one training batch (a labelled
        :class:`~repro_torch.core.batching.PaddedGraphBatch`).  ``pad="auto"``
        packs a fixed-size sampler exactly (dense) and pads a mixed-size one
        to the power-of-two bucket."""
        from .costmodel import PipelineSystem
        from .rl import pack_graphs
        system = (system or PipelineSystem(n_stages)).with_stages(n_stages)
        if pad == "auto":
            pad = isinstance(self.n, tuple)
        return pack_graphs(self.next_batch(batch), n_stages, system, max_deg=max_deg,
                           label_method=label_method, cache_dir=self.label_cache_dir,
                           pad=pad, device=device)

    def packed_stream(self, batch: int, n_stages: int, system=None, max_deg: int = 6,
                      label_method: str = "dp", epochs: int | None = None,
                      batches_per_epoch: int = 64, curriculum: bool = False, bucket: bool = True,
                      pad_batch_dim: bool = True, batch_divisor: int = 1, device=None):
        """Iterator of labelled packs, the training feed (the reference's
        ``packed_stream``).

        Each draw samples ``batch`` graphs from the (seed, counter) stream;
        with ``bucket`` they group by power-of-two size bucket, one pack a
        bucket; with ``pad_batch_dim`` a pack's batch dim pads to its own
        power of two with inert ``n_valid = 0`` rows, and ``batch_divisor``
        rounds it up to a multiple.  ``curriculum`` widens the size range
        from its lower end to the full range over the counter's first
        ``batches_per_epoch`` draws.  Every draw, ramp included, is a pure
        function of (seed, counter), so a restored :meth:`state` resumes the
        stream.  ``epochs=None`` streams forever."""
        from .batching import bucketize
        from .costmodel import PipelineSystem
        from .rl import pack_graphs
        system = (system or PipelineSystem(n_stages)).with_stages(n_stages)
        full_n = self.n
        epoch = 0
        while epochs is None or epoch < epochs:
            for _ in range(batches_per_epoch):
                n_spec = full_n
                if curriculum and isinstance(full_n, tuple) and self._count < batches_per_epoch:
                    lo, hi = full_n
                    frac = (self._count + 1) / batches_per_epoch
                    n_spec = (lo, lo + max(1, int((hi - lo) * frac)))
                rng = np.random.default_rng((self.seed, self._count))
                self._count += 1
                graphs = sample_batch(rng, batch, n=n_spec, degs=self.degs)
                groups = bucketize(graphs).values() if bucket else [list(range(len(graphs)))]
                for idxs in groups:
                    pack = pack_graphs(
                        [graphs[i] for i in idxs], n_stages, system, max_deg=max_deg,
                        label_method=label_method, cache_dir=self.label_cache_dir,
                        pad=isinstance(n_spec, (tuple, list)), device=device)
                    target = pack.batch
                    if pad_batch_dim and pack.batch != len(graphs):
                        target = 1 << (pack.batch - 1).bit_length()
                    if target % batch_divisor:
                        target += batch_divisor - target % batch_divisor
                    if target != pack.batch:
                        pack = pack.pad_batch(target)
                    yield pack
            epoch += 1

    def state(self) -> dict:
        return {"seed": self.seed, "count": self._count}

    def restore(self, state: dict) -> None:
        self.seed = int(state["seed"])
        self._count = int(state["count"])


class _Prefetcher:
    """Pulls from ``it`` on a daemon thread into a bounded queue; an
    exception in the producer is raised on the consumer's side."""

    _DONE = object()

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._pull, args=(it,), daemon=True)
        self._thread.start()

    def _pull(self, it):
        try:
            for item in it:
                self._q.put(item)
        except BaseException as e:   # re-raised on the consumer side
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch(it, depth: int = 2):
    """Wrap an iterator with background prefetch (``depth`` items ahead)."""
    return _Prefetcher(it, depth)
