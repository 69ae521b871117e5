"""Serve scheduling traffic through the async front end: the port's twin of
``examples/serve_traffic.py``.

Starts a :class:`~repro_torch.serving.SchedulerService` over a seeded
scheduler (``RespectScheduler.init(seed=0, hidden=64)``: B1 in its cluster
template on the card), warms the bucket shapes the traffic will hit, replays
two bursts of a mixed-size request stream (eight synthetic DAGs and
ResNet50, drawn from ``numpy.random.default_rng(0)`` as the reference draws
them), and prints the service's rolling metrics.  The first burst misses
and fills the schedule cache; the second is served from the cache and by
deduplication.

The reference's ``max_compiled`` (XLA's program cache) has no counterpart:
the warm line prints the number of batch shapes ``warmup`` ran.
:func:`serve_traffic` returns everything as data.

    python -m repro_torch.serve_traffic [--requests 80] [--device cpu]

Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .core import RespectScheduler, build_model_graph, sample_dag
from .device import resolve_device
from .serving import SchedulerService

__all__ = ["traffic_pool", "serve_traffic", "main"]

BURSTS = ("burst 1 (cold: misses + batch-shape builds)", "burst 2 (warm: schedule cache + dedup)")


def traffic_pool(rng: np.random.Generator) -> list:
    """Eight synthetic DAGs of 10-32 nodes and ResNet50, as the reference
    draws them."""
    pool = [sample_dag(rng, n=int(rng.integers(10, 33)), deg=3) for _ in range(8)]
    pool.append(build_model_graph("ResNet50"))
    return pool


def serve_traffic(sched: RespectScheduler, requests: int = 80, max_batch: int = 16,
                  max_wait_ms: float = 3.0, stages: int = 4) -> dict:
    """Warm up, then two bursts of ``requests`` each.  Returns the pool, the
    warm keys and seconds, per burst its tag, its requests' pool indices,
    results and seconds, and the service's final :class:`ServiceStats`."""
    rng = np.random.default_rng(0)
    pool = traffic_pool(rng)
    bursts = []
    with SchedulerService(sched, max_batch=max_batch, max_wait_ms=max_wait_ms) as svc:
        t0 = time.perf_counter()
        keys = svc.warmup(pool, n_stages=stages)
        t_warm = time.perf_counter() - t0
        for tag in BURSTS:
            t0 = time.perf_counter()
            idx, futs = [], []
            for _ in range(requests):
                idx.append(int(rng.integers(0, len(pool))))
                futs.append(svc.submit(pool[idx[-1]], stages))
            out = [f.result(timeout=300) for f in futs]
            bursts.append({"tag": tag, "pool_index": idx, "results": out,
                           "seconds": time.perf_counter() - t0})
        st = svc.stats()
    return {"pool": pool, "warm_keys": keys, "warm_s": t_warm, "bursts": bursts, "stats": st}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve_traffic")
    ap.add_argument("--requests", type=int, default=80)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=3.0)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    sched = RespectScheduler.init(seed=0, hidden=args.hidden, device=resolve_device(args.device))
    out = serve_traffic(sched, args.requests, args.max_batch, args.max_wait_ms, args.stages)
    print("warming expected bucket shapes ...")
    print(f"  warm in {out['warm_s']:.1f}s ({len(out['warm_keys'])} batch shapes)")
    print(f"replaying two bursts of {args.requests} requests (pool of {len(out['pool'])} "
          "graphs) ...")
    for b in out["bursts"]:
        n, dt = len(b["results"]), b["seconds"]
        print(f"  {b['tag']}: {n} schedules in {dt:.2f}s ({n / dt:.1f} graphs/s)")
    st = out["stats"]
    print(f"  rolling latency p50={st.p50_ms:.2f}ms p99={st.p99_ms:.2f}ms")
    print(f"  batches={st.batches} (largest {st.max_batch_observed}); "
          f"hits={st.cache_hits} misses={st.cache_misses} dedups={st.dedup_hits}")
    r = out["bursts"][-1]["results"][-1]
    print(f"  last result: model={r['model']} stages -> "
          f"{np.bincount(r.assignment, minlength=args.stages).tolist()} nodes per stage")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
