"""Data parallelism over ``torch.distributed`` (the roles of the reference's
``sharding.data_parallel_mesh``/``batch_sharding`` and ``launch/mesh.py``'s
data mesh).

A world of ``n`` ranks takes the place of the reference's one-axis ``data``
mesh: each rank holds the replicated parameters and a contiguous slice of
the global batch (:func:`rank_slice`), as ``P("data")`` shards it.

* :func:`init_data_parallel` joins one rank to its world.
* :func:`run_ranks` starts ``n`` ranks with ``spawn``, each in a process of
  its own, joins them through a ``FileStore`` in a temporary directory (no
  TCP port to clash with another run) and waits for all of them with a
  timeout.  A rank that raises, or a run that overstays its timeout, kills
  every rank and raises in the caller with the failing rank's traceback: a
  rank's failure fails the run.

The backend is an explicit argument and never changes unasked: ``"nccl"``
where each rank has its own card, ``"gloo"`` otherwise (gloo all-reduces
and broadcasts CUDA tensors, so several ranks may share one card; NCCL
refuses two ranks on one device).  A rank never carries on on the CPU when
it was given a card.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

__all__ = ["BACKENDS", "DataWorld", "init_data_parallel", "current_world", "rank_slice",
           "rank_device", "run_ranks", "RankFailure"]

#: the process-group backends a data-parallel run may name
BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class DataWorld:
    """One rank's view of its data-parallel world."""
    rank: int
    size: int
    backend: str

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        dist.barrier()


def init_data_parallel(n: int, *, backend: str, init_method: str, rank: int | None = None,
                       timeout_s: float = 600.0) -> DataWorld:
    """Join this process to a world of ``n`` ranks as ``rank`` (default: the
    ``RANK`` environment variable) over ``backend`` (``"gloo"`` or
    ``"nccl"``) at ``init_method`` (``file://...`` or ``tcp://host:port``).
    Collectives that wait longer than ``timeout_s`` raise."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if rank is None:
        rank = int(os.environ["RANK"])
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a world of {n}")
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return DataWorld(rank, n, backend)


def current_world() -> DataWorld | None:
    """The initialised world of this process, or None."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return DataWorld(dist.get_rank(), dist.get_world_size(), dist.get_backend())


def rank_slice(x, rank: int, world: int):
    """Rank ``rank``'s contiguous slice of a global batch: a
    :class:`~repro_torch.core.batching.PaddedGraphBatch`, a tensor or a numpy
    array (keys (B, 2)) along its first dimension.  A batch that the world
    does not divide raises ``ValueError``, as the reference's sharded step
    does."""
    from ..core.batching import PaddedGraphBatch
    total = x.batch if isinstance(x, PaddedGraphBatch) else x.shape[0]
    if total % world:
        raise ValueError(f"global batch {total} not divisible by "
                         f"{world} devices on mesh axis 'data'")
    per = total // world
    lo, hi = rank * per, (rank + 1) * per
    if isinstance(x, PaddedGraphBatch):
        return dataclasses.replace(x, **{k: None if v is None else v[lo:hi]
                                         for k, v in x._tensors().items()})
    return x[lo:hi]


def rank_device(rank: int, n: int, backend: str, device=None,
                share_device: bool = False) -> torch.device:
    """The device rank ``rank`` of ``n`` runs on.  ``device`` None or
    ``"cuda"``: card ``rank`` (every rank on the current card with
    ``share_device``, which only gloo permits); ``"cpu"``: the host.  Asking
    for more ranks than there are cards raises, as the reference's
    ``data_parallel_mesh`` does."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("nccl runs on cards only; ranks on the CPU take gloo")
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the ranks on "
                           "the CPU")
    if share_device:
        if backend == "nccl":
            raise ValueError("nccl refuses two ranks on one device; ranks that share a "
                             "card take gloo")
        return torch.device("cuda", dev.index or 0)
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f"asked for {n} devices, have {have} (ranks that share a card "
                         "need share_device=True and the gloo backend)")
    return torch.device("cuda", rank)


class RankFailure(RuntimeError):
    """A rank of :func:`run_ranks` failed or the run timed out."""


def _rank_main(rank, n, backend, device, init_method, fn, args, results, timeout_s):
    """One spawned rank: join the world, run ``fn(world, device, *args)``,
    send back its result or its exception and traceback."""
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:   # ranks that share the host split its cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        world = init_data_parallel(n, backend=backend, init_method=init_method, rank=rank,
                                   timeout_s=timeout_s)
        try:
            out = fn(world, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out, None))
    except BaseException as e:   # reported to the caller, which kills the other ranks
        tb = traceback.format_exc()
        try:
            results.put((rank, False, e, tb))
        except Exception:        # an exception that does not pickle
            results.put((rank, False, None, tb))


def run_ranks(fn, n: int, *, backend: str, device=None, timeout_s: float = 600.0,
              args: tuple = (), share_device: bool = False) -> list:
    """Run ``fn(world, device, *args)`` on ``n`` spawned ranks and return
    their results in rank order.

    ``fn`` must be importable (a module-level function of a package), and
    ``args`` and the results must pickle.  Each rank joins a ``FileStore``
    in a fresh temporary directory; ``device`` and ``share_device`` place
    the ranks as :func:`rank_device` says.  A rank that raises, or a run
    past ``timeout_s``, terminates every rank and raises: the rank's own
    exception where it pickles, with its traceback attached, else
    :class:`RankFailure`."""
    devices = [rank_device(r, n, backend, device, share_device) for r in range(n)]
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init_method = "file://" + os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, backend, devices[r], init_method, fn, args, results,
                               timeout_s))
             for r in range(n)]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(out) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RankFailure(f"{n} ranks did not finish within {timeout_s:.0f} s; "
                                  f"ranks {sorted(set(range(n)) - set(out))} still running")
            try:
                rank, ok, value, tb = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive() and p.exitcode not in (None, 0)]
                if dead:
                    r = dead[0]
                    raise RankFailure(f"rank {r} of {n} died with exit code "
                                      f"{procs[r].exitcode} and reported nothing")
                continue
            if not ok:
                msg = f"rank {rank} of {n} failed:\n{tb}"
                if isinstance(value, BaseException):
                    value.add_note(msg)
                    raise value
                raise RankFailure(msg)
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
