"""Rank bodies of sharded execution: the LM zoo's steps on a (data, model)
``DeviceMesh`` of a world that :func:`repro_torch.parallel.data.run_ranks`
spawned (gloo ranks on the CPU or sharing one card, or NCCL ranks one a
card).  ``tests/test_torch_sharded_exec.py`` and ``chip_smoke.py`` run them.

:func:`run_jobs` is the spawnable body: ``run_ranks(run_jobs, n,
args=(jobs,))`` runs each job dict on every rank, in order, and returns one
list of results a rank.  A job's ``"kind"`` names its function:

* ``"steps"`` (:func:`steps_job`) — one arch on one mesh through the step
  makers: prefill, greedy decode steps, the sharded ``value_and_grad`` and
  train steps, and the trained state saved and restored onto another mesh
  (reshard on load);
* ``"train_loop"`` (:func:`train_loop_job`) — a sharded ``TrainLoop`` run
  straight through, and stopped and resumed through ``shardings=``;
* ``"collectives"`` (:func:`collectives_job`) — the functional collectives
  that ``DTensor`` issues, on this world's devices;
* ``"faults"`` (:func:`faults_job`) — the local-shard helpers on the
  offsets of ranks other than 0 (``_sharded_nll``, ``write_seq``,
  ``whole_product``'s backward, the flash and SSD backwards, the MoE's slot
  positions, an MLA decode step over a sequence-split latent cache).

Every value a job reports is gathered to a full tensor.  Each rank returns
its sha256 under ``"digests"``, so that a caller can hold the ranks'
replicated values to one another bit for bit; rank 0 also returns it as a
numpy array under ``"arrays"`` (with ``keep=True``, or those whose names start
with one of the prefixes ``keep`` gives), and, given a
``reference`` file (``torch.save`` of name -> tensor), every rank returns
under ``"errors"`` its largest difference from the reference's tensor of
that name, the reference's largest magnitude, and the largest difference
less :data:`BF16_RTOL` times the reference's magnitude there.
``"launches"`` counts a rank's B3 and B4 launches a phase, ``"ms"`` its
host-clock milliseconds (the card synchronized first).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time

import numpy as np
import torch

from .. import optim
from ..configs import ShapeConfig, TrainConfig, get_config, get_smoke_config
from ..kernels import build
from ..models.lm import params_from_numpy
from ..models.mlp import recorded_routes
from ..models.model import build_model
from ..parallel.sharding import gather_tree, shard_tree
from .mesh import device_mesh
from .steps import (make_decode_step, make_prefill_step, make_train_step, named_leaves,
                    value_and_grad)

__all__ = ["NAMES", "KERNELS", "BF16_RTOL", "JOBS", "run_jobs", "steps_job",
           "train_loop_job", "collectives_job", "faults_job", "numpy_of", "n_prefix", "config_of",
           "input_records", "model_inputs", "batch_of", "put_routes"]

#: the mesh axes of every job
NAMES = ("data", "model")
#: the launch counters a job reports (B3, B4)
KERNELS = ("flash_fwd", "ssd_scan")
#: the relative part of the zoo's bf16 bound: an error against a reference
#: reports max(|d| - BF16_RTOL |want|), which that bound holds to its atol
BF16_RTOL = 2e-2
#: elements a block when a value is held to its reference
HOLD_BLOCK = 1 << 22


def numpy_of(t) -> np.ndarray:
    """A full tensor (a ``DTensor`` gathered) as a host numpy array of its
    own (a copy: a cache written in place later does not change it); a
    bfloat16 one widened to float32 (exactly)."""
    t = t.full_tensor() if hasattr(t, "device_mesh") else t
    t = t.detach()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy())


class _Report:
    """A job's result: digests (every rank), arrays (rank 0, with ``keep``:
    True, or the name prefixes to keep), differences from a reference,
    launch counts and host-clock ms by phase."""

    def __init__(self, rank: int, device: torch.device, keep: bool | tuple = True,
                 reference: str | None = None):
        self.rank, self.device, self.keep = rank, device, keep
        # mapped, not read: the ranks of one host share its page cache, and
        # each touches only the slices it holds
        self.ref = {} if reference is None else torch.load(reference, map_location="cpu",
                                                            mmap=True)
        self.out = {"rank": rank, "device": str(device), "arrays": {}, "digests": {},
                    "errors": {}, "launches": {}, "ms": {}}

    def put(self, name: str, t) -> np.ndarray:
        a = numpy_of(t)
        self.out["digests"][name] = hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
        if self.keeps(name) and self.rank == 0:
            self.out["arrays"][name] = a
        if name in self.ref:
            self._hold(name, torch.from_numpy(a), self.ref[name])
        return a

    def keeps(self, name: str) -> bool:
        return self.keep is True or (bool(self.keep) and name.startswith(tuple(self.keep)))

    def _hold(self, name: str, got: torch.Tensor, want: torch.Tensor) -> None:
        """Record ``got``'s errors against the reference's ``want``, a block
        of :data:`HOLD_BLOCK` elements at a time (a vocabulary's gradient
        in float64 at once would be ~3 GB a temporary on each rank), on
        ``got``'s device (a rank's shard on the card: qwen3-moe's experts'
        gradients are 2.4 GB of bf16 a rank)."""
        got, want = got.reshape(-1), want.reshape(-1)
        if not got.numel():
            self.out["errors"][name] = (float("nan"),) * 3
            return
        acc = torch.full((3,), float("-inf"), dtype=torch.float64, device=got.device)
        for i in range(0, got.numel(), HOLD_BLOCK):
            g = got[i: i + HOLD_BLOCK].double()
            w = want[i: i + HOLD_BLOCK].to(got.device).double()
            d, a = (g - w).abs(), w.abs()
            acc = torch.maximum(acc, torch.stack((d.max(), a.max(), (d - BF16_RTOL * a).max())))
        self.out["errors"][name] = tuple(acc.tolist())

    def put_tree(self, prefix: str, tree) -> None:
        for name, leaf in named_leaves(tree):
            if leaf is not None:
                self.put(f"{prefix}/{name}", leaf)

    def put_shards(self, prefix: str, tree) -> None:
        """A tree of sharded values: gathered and put with ``keep``; else
        each rank's local shard held to its slice of the reference (no
        gather, no digest: the shards differ by rank)."""
        if self.keeps(prefix + "/"):
            self.put_tree(prefix, gather_tree(tree))
            return
        for name, leaf in named_leaves(tree):
            key = f"{prefix}/{name}"
            if leaf is not None and key in self.ref:
                self._hold(key, _local(leaf, host=False), _local_slice(leaf, self.ref[key]))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a phase (appending to its list of ms) and count its B3/B4
        launches: the counters are set to 0 just before it and read just
        after."""
        for k in build.LAUNCHES:
            build.LAUNCHES[k] = 0
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.out["ms"].setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        counts = self.out["launches"].setdefault(name, dict.fromkeys(KERNELS, 0))
        for k in KERNELS:
            counts[k] += build.LAUNCHES[k]


def _local(t, host: bool = True) -> torch.Tensor:
    """This rank's shard of ``t`` (``t`` itself if plain), on the host (or
    where it is); a partial sum reduced first."""
    if hasattr(t, "device_mesh"):
        from torch.distributed.tensor import Replicate
        t = t.redistribute(t.device_mesh, tuple(Replicate() if p.is_partial() else p
                                                for p in t.placements)).to_local()
    return t.detach().cpu() if host else t.detach()


def _local_slice(t, full: torch.Tensor) -> torch.Tensor:
    """The region of ``full`` (a host tensor of ``t``'s global shape) that
    this rank's shard of the ``DTensor`` ``t`` holds."""
    if not hasattr(t, "device_mesh"):
        return full
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    return full[tuple(slice(o, o + n) for o, n in zip(off, shape))]


def n_prefix(cfg) -> int:
    """Positions before the text in a sequence of ``cfg``: the VLM's patches."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def input_records(model, b: int, s: int) -> tuple[dict, dict]:
    """(specs, logical axes) of a train or prefill batch of ``b`` rows of
    ``s`` text tokens: :meth:`~repro_torch.models.model.Model.input_records`
    of a cell whose sequence holds the VLM's patches before the text."""
    return model.input_records(ShapeConfig("ranks", s + n_prefix(model.cfg), b, "prefill"))


def model_inputs(model, tokens: np.ndarray, seed: int = 0) -> dict:
    """The numpy batch of ``model`` around ``tokens`` (B, S): every other
    input of :func:`input_records` (whisper's ``audio_embed``, the VLM's
    ``patches``) drawn N(0, 1) in float32 from
    ``numpy.random.default_rng(seed)``, in the records' order."""
    specs, _ = input_records(model, *tokens.shape)
    rng = np.random.default_rng(seed)
    return {name: tokens if name == "tokens" else
            rng.standard_normal(spec.shape).astype(np.float32) for name, spec in specs.items()}


def batch_of(arrays: dict, specs: dict, device) -> dict:
    """A numpy batch as tensors on ``device``, each in its record's dtype
    (the frame and patch embeddings in bfloat16, as the reference's
    ``input_specs`` give them)."""
    return {k: torch.from_numpy(np.asarray(arrays[k])).to(device, specs[k].dtype) for k in specs}


def config_of(arch: str, smoke: bool = True, dtype: str = "float32",
              n_layers: int | None = None, capacity_factor: float | None = None):
    """``arch``'s SMOKE or full config in ``dtype``, its depth cut to
    ``n_layers`` and its MoE's capacity factor set to ``capacity_factor``
    where given."""
    cfg = (get_smoke_config if smoke else get_config)(arch).scaled(dtype=dtype)
    if n_layers is not None:
        cfg = cfg.scaled(n_layers=n_layers)
    if capacity_factor is not None:
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
    return cfg


def _model(arch: str, smoke: bool, dtype: str, n_layers: int | None, device,
           remat: bool = False, capacity_factor: float | None = None):
    return build_model(config_of(arch, smoke, dtype, n_layers, capacity_factor), device=device,
                       remat=remat)


def _params(model, params, seed: int, device):
    """The numpy tree ``params`` on ``device``, or the model's seeded init
    there (the same on every rank)."""
    if params is not None:
        return params_from_numpy(model.cfg, params, device)
    return model.init_params(seed=seed)


def _sharded_params(world, model, params, seed: int, device, shardings):
    """:func:`_params` at ``shardings``.  Ranks that share one card (gloo on
    CUDA) make theirs in turn, each freeing its whole tree before the next
    starts: four whole trees at once can run the card out of memory (four
    qwen3-moe layers' experts)."""
    if world.backend != "gloo" or device.type != "cuda":
        return shard_tree(_params(model, params, seed, device), shardings)
    import torch.distributed as dist
    out = None
    for turn in range(world.size):
        if turn == world.rank:
            out = shard_tree(_params(model, params, seed, device), shardings)
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _at(tree, shardings) -> bool:
    """Every ``DTensor`` leaf of ``tree`` is at its sharding's placements."""
    return all(tuple(t.placements) == sh.placements
               for (_, t), (_, sh) in zip(named_leaves(tree), named_leaves(shardings))
               if t is not None)


def _kernel_names(fn) -> tuple:
    """(``fn()``, the count of its device kernels by name, of those whose
    name holds ``flash_fwd`` or ``ssd_scan``), run under the profiler.  The
    window opens with a ~10 ms spin on the card: late in a long process the
    profiler's device clock drifts from its host clock, and a window drops
    the kernels that seem to start before it opened."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)           # cycles
        torch.cuda.synchronize()
        res = fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and ("flash_fwd" in e.name or "ssd_scan" in e.name):
            out[e.name] = out.get(e.name, 0) + 1
    return res, out


def steps_job(world, device, *, arch: str, mesh: tuple, tokens: np.ndarray, inputs=None,
              params=None, seed: int = 0, smoke: bool = True, dtype: str = "float32",
              n_layers: int | None = None, max_len=None,
              decode: int = 3, feed=None, train: int = 0, microbatches: int = 2,
              grads: bool = False, full_params: bool = True, train_layers: int | None = None,
              save_dir: str | None = None, resume_mesh: tuple | None = None,
              keep: bool | tuple = True, reference: str | None = None, profile: bool = False,
              remat: bool = False, capacity_factor: float | None = None) -> dict:
    """``arch`` on ``mesh`` through the step makers:

    * the prefill of ``tokens`` (B, S) and the model's other ``inputs``
      (numpy arrays, :func:`model_inputs`; whisper's frames, the VLM's
      patches) into a cache of ``max_len`` (default the VLM's patches + S
      + decode), and ``decode`` greedy steps: each reports the argmax of
      the gathered logits as its token and feeds it, or ``feed[i]`` where
      given; each MoE layer's routes, slot positions and drops beside them
      (``prefill/routes/<call>/...``, ``decode/<i>/routes/...``);
    * the sharded ``value_and_grad`` of the loss (``grads``);
    * ``train`` train steps (``TrainConfig(microbatches=...)``), parameters
      gathered after the first (``full_params``), leaf norms after each; a
      model of ``train_layers`` layers (its own seeded init) where given;
    * with ``save_dir``, the trained parameters and optimizer state saved
      there (``CheckpointManager``) and restored onto ``resume_mesh``: each
      leaf compared bit for bit with the saved one and its placements with
      the new mesh's shardings.

    ``params`` is a numpy tree, else the seeded init (the same on every
    rank); ``n_layers`` cuts the model's depth, ``capacity_factor`` sets an
    MoE's, and ``remat`` rematerializes the loss's unit bodies (the
    gradients and train steps).  With ``profile`` the prefill runs under
    the profiler and its B3/B4 kernels are counted by name."""
    rep = _Report(world.rank, device, keep, reference)
    model = _model(arch, smoke, dtype, n_layers, device, remat, capacity_factor)
    dmesh = device_mesh(mesh, NAMES, device)
    b, s = tokens.shape
    s += n_prefix(model.cfg)                   # the sequence the cache holds
    max_len = max_len or s + decode
    specs, axes = input_records(model, b, tokens.shape[1])
    prefill, (p_sh, b_sh) = make_prefill_step(model, dmesh, specs, axes)
    dparams = _sharded_params(world, model, params, seed, device, p_sh)
    batch = shard_tree(batch_of({"tokens": tokens, **(inputs or {})}, specs, device), b_sh)
    with rep.phase("prefill"), recorded_routes() as routes:
        if profile:
            run = lambda: prefill(dparams, batch, max_len=max_len)      # noqa: E731
            (logits, cache), rep.out["kernel_names"] = _kernel_names(run)
        else:
            logits, cache = prefill(dparams, batch, max_len=max_len)
    rep.put("prefill/logits", logits)
    put_routes(rep.put, "prefill", routes)
    rep.put_shards("prefill/cache", cache)
    dec, (_, tok_sh, c_sh) = make_decode_step(model, dmesh, b, max_len)
    rep.out["cache_at_shardings"] = _at(cache, c_sh)
    for i in range(decode):
        tok = logits.full_tensor()[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        rep.put(f"decode/{i}/token", tok)
        if feed is not None:
            tok = torch.from_numpy(feed[i]).to(device)
        with rep.phase("decode"), recorded_routes() as routes:
            logits, cache = dec(dparams, shard_tree(tok, tok_sh), cache, s + i)
        rep.put(f"decode/{i}/logits", logits)
        put_routes(rep.put, f"decode/{i}", routes)
    if decode:
        rep.put_shards("decode/cache", cache)
    del cache, logits
    if not (grads or train):
        return rep.out
    if train_layers is not None:
        del dparams
        model = _model(arch, smoke, dtype, train_layers, device, remat, capacity_factor)
    tcfg = TrainConfig(microbatches=microbatches)
    step, (p_sh, o_sh, _), optimizer = make_train_step(model, dmesh, tcfg, specs, axes)
    if train_layers is not None:
        dparams = _sharded_params(world, model, None, seed, device, p_sh)
    if grads:
        from torch.distributed.tensor.experimental import implicit_replication
        with rep.phase("grads"), implicit_replication():
            loss, g = value_and_grad(model.loss, dparams, batch)
        rep.put("grads/loss", loss)
        rep.put_shards("grads", g)
        del g
    opt_state = shard_tree(optimizer.init(dparams), o_sh)
    for i in range(train):
        with rep.phase("train"):
            dparams, opt_state, metrics = step(dparams, opt_state, batch)
        for k in ("loss", "grad_norm", "step"):
            rep.put(f"train/{i}/{k}", metrics[k])
        if rep.keeps(f"train/{i}/leaf_norms"):
            norms = [float(torch.linalg.vector_norm(t.full_tensor().double()))
                     for _, t in named_leaves(dparams)]
            rep.put(f"train/{i}/leaf_norms", torch.tensor(norms, dtype=torch.float64))
        if i == 0 and full_params:
            rep.put_tree("train/params", gather_tree(dparams))
        rep.out["train_at_shardings"] = _at(dparams, p_sh) and _at(opt_state.tree(),
                                                                   o_sh.tree())
    rep.out["train_leaf_names"] = [n for n, _ in named_leaves(p_sh)]
    if save_dir is not None:
        _resume(rep, model, optimizer, {"params": dparams, "opt_state": opt_state.tree()},
                save_dir, train, resume_mesh, device)
    if device.type == "cuda":
        rep.out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return rep.out


def put_routes(put, prefix: str, routes: list) -> None:
    """An MoE's recorded routes (:func:`~repro_torch.models.mlp.recorded_routes`)
    under ``prefix/routes/<call>/{top_e,pos,keep}``."""
    for j, r in enumerate(routes):
        for name in ("top_e", "pos", "keep"):
            put(f"{prefix}/routes/{j}/{name}", getattr(r, name))


def _resume(rep, model, optimizer, state: dict, directory: str, step: int, mesh: tuple,
            device) -> None:
    """Save ``state`` as ``step`` in ``directory`` and restore it onto
    ``mesh``: every rank holds its shard of each saved leaf and of the
    restored one to the same region of the written file, bit for bit (so
    restored equals saved, with no gather), and the restored leaves are at
    the new mesh's shardings (reported gathered with ``keep``)."""
    from ..checkpoint import CheckpointManager
    from ..checkpoint.manager import _tensor, read_leaves
    from .steps import opt_shardings, param_shardings
    mgr = CheckpointManager(directory)
    with rep.phase("save"):
        mgr.save(step, state)
    dmesh = device_mesh(mesh, NAMES, device)
    sh = {"params": param_shardings(model, dmesh),
          "opt_state": opt_shardings(optimizer, model, dmesh).tree()}
    with rep.phase("restore"):
        restored = mgr.restore(step, state, sh)
    stored = read_leaves(mgr.directory / f"step_{step:08d}")
    same = []
    for (name, a), (_, r) in zip(named_leaves(state), named_leaves(restored)):
        if a is not None:
            full = _tensor(stored[name])
            same.append(all(bool(torch.equal(_local(t), _local_slice(t, full))) for t in (a, r)))
            if rep.keeps(f"restored/{name}"):
                rep.put(f"restored/{name}", r)
    rep.out["resume"] = {"leaves": len(same), "equal": sum(same), "mesh": list(mesh),
                         "at_shardings": _at(restored, sh)}


def collectives_job(world, device, *, mesh: tuple = (1, 4)) -> dict:
    """The functional collectives that ``DTensor`` issues, along ``model``
    of ``mesh`` on this world's devices, against their results computed on
    the host: all_gather_into_tensor (over gloo on the card:
    :func:`~repro_torch.parallel.collectives.shared_card_all_gather`),
    reduce_scatter_tensor, all_reduce and all_to_all_single, and, in a gloo
    world, ``shared_card_all_gather`` called directly.  Reports each one's
    agreement and this rank's uses of the shared card's route."""
    import torch.distributed._functional_collectives as funcol

    from ..parallel.collectives import USES, shared_card_all_gather
    dmesh = device_mesh(mesh, NAMES, device)
    group, n, r = dmesh.get_group(1), dmesh.size(1), dmesh.get_local_rank(1)
    before = dict(USES)

    def mine(j):
        return torch.arange(4 * n, dtype=torch.float32) + 100 * j

    x = mine(r).to(device)
    want = {"all_gather_into_tensor": torch.cat([mine(j) for j in range(n)]),
            "reduce_scatter_tensor": sum(mine(j) for j in range(n)).chunk(n)[r],
            "all_reduce": sum(mine(j) for j in range(n)),
            "all_to_all_single": torch.cat([mine(j).chunk(n)[r] for j in range(n)])}
    got = {"all_gather_into_tensor": funcol.all_gather_tensor(x, 0, group),
           "reduce_scatter_tensor": funcol.reduce_scatter_tensor(x, "sum", 0, group),
           "all_reduce": funcol.all_reduce(x, "sum", group),
           "all_to_all_single": funcol.all_to_all_single(x, None, None, group)}
    if world.backend == "gloo":       # the shared card's route, called as itself
        got["shared_card_all_gather"] = shared_card_all_gather(x, n, group.group_name)
        want["shared_card_all_gather"] = want["all_gather_into_tensor"]
    ok = {k: bool(torch.equal(torch.as_tensor(got[k]).cpu(), want[k])) for k in want}
    return {"rank": world.rank, "device": str(device), "backend": world.backend, "ok": ok,
            "shared_card_uses": {k: USES[k] - before.get(k, 0) for k in USES}}


def train_loop_job(world, device, *, arch: str, mesh: tuple, directory: str, steps: int,
                   stop: int, batch: int, seq: int, params=None, seed: int = 0,
                   smoke: bool = True, dtype: str = "float32", microbatches: int = 2) -> dict:
    """``TrainLoop`` on ``mesh``: ``steps`` steps straight through (in
    ``directory``/full), and ``stop`` steps then a second loop to ``steps``
    that resumes through ``shardings=`` (in ``directory``/resumed) from
    parameters it was not given.  Batch ``i`` is the tokens of
    ``numpy.random.default_rng(i)`` (``batch`` x ``seq``) and the model's
    other inputs from the same seed (:func:`model_inputs`).  Reports both
    runs' final parameters and metrics."""
    from ..runtime import TrainLoop, TrainLoopConfig
    rep = _Report(world.rank, device)
    model = _model(arch, smoke, dtype, None, device)
    dmesh = device_mesh(mesh, NAMES, device)
    specs, axes = input_records(model, batch, seq)
    step, (p_sh, o_sh, b_sh), optimizer = make_train_step(
        model, dmesh, TrainConfig(microbatches=microbatches), specs, axes)
    host = _params(model, params, seed, device)

    def batch_fn(i):
        toks = np.random.default_rng(i).integers(0, model.cfg.vocab_size, (batch, seq))
        return shard_tree(batch_of(model_inputs(model, toks.astype(np.int32), i), specs, device),
                          b_sh)

    def loop(total, start_params, sub):
        dparams = shard_tree(start_params, p_sh)
        opt_state = shard_tree(optimizer.init(dparams), o_sh)
        tl = TrainLoop(step, batch_fn, dparams, opt_state,
                       TrainLoopConfig(total_steps=total, save_every=stop, log_every=10 ** 9),
                       f"{directory}/{sub}", shardings=(p_sh, o_sh))
        res = tl.run()
        return tl, res

    full, full_res = loop(steps, host, "full")
    loop(stop, host, "resumed")
    resumed, resumed_res = loop(steps, optim.tree_map(torch.zeros_like, host), "resumed")
    rep.out["resumed_from"] = resumed.start_step
    rep.out["metrics"] = {"full": full_res, "resumed": resumed_res}
    rep.out["resumed_at_shardings"] = _at(resumed.params, p_sh)
    rep.put_tree("full", full.params)
    rep.put_tree("resumed", resumed.params)
    return rep.out


def faults_job(world, device, *, mesh: tuple, nll: dict | None = None,
               seq: dict | None = None, product: dict | None = None, flash: dict | None = None,
               ssd: dict | None = None, embed: dict | None = None,
               decode: dict | None = None, slstm: dict | None = None,
               moe: dict | None = None, mla: dict | None = None) -> dict:
    """The local-shard helpers on ``mesh`` (a 4-way ``model`` axis, so that
    ranks 1-3 hold shards at offsets other than 0), each given one on numpy
    inputs:

    * ``nll`` {"logits", "labels"}: ``softmax_cross_entropy`` with the
      vocabulary split;
    * ``seq`` {"cache", "val", "start"}: ``write_seq`` into a cache split
      along the sequence, ``val`` straddling two ranks' shards;
    * ``product`` {"x", "w"}: ``whole_product`` and the gradients of the
      sum of its squares;
    * ``flash`` {"q", "k", "v", "dout"}: ``flash_attention`` under autograd
      with the query heads split and the key/value heads whole;
    * ``ssd`` {"x", "dt", "A", "B", "C", "dy"}: ``ssd_scan`` under autograd
      with the heads split and the B/C groups whole;
    * ``embed`` {"table", "tokens", "dout"}: ``embed_lookup`` under autograd
      with the vocabulary split (the table's rows);
    * ``decode`` {"q", "k", "v", "kv_len"}: ``decode_attention`` over a
      cache split along the sequence;
    * ``slstm`` {"pre", "r_h", "dout", "nh"}: the sLSTM's training scan over
      ``DTensor``s (``_slstm_local``; the batch split along ``data``) under
      autograd;
    * ``moe`` {"top_e", "n_experts"}: the MoE's slot positions
      (``slot_positions``) with the tokens split along ``model``;
    * ``mla`` {"arch", "params", "x", "ckv", "krope", "kv_len"}: one MLA
      decode step of ``arch``'s SMOKE config (``mla_forward``: the latent
      cache write and the absorbed attention) over a latent cache split
      along the sequence.

    Reports each output and gradient, gathered."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from ..kernels.flash.ops import decode_attention, flash_attention
    from ..kernels.ssd.ops import ssd_scan
    from ..models.common import embed_lookup, softmax_cross_entropy, whole_product, write_seq
    rep = _Report(world.rank, device)
    dmesh = device_mesh(mesh, NAMES, device)
    rep.out["model_rank"] = dmesh.get_local_rank(1)

    def put(a, *placements, grad=False):
        pl = tuple(placements) + (Replicate(),) * (dmesh.ndim - len(placements))
        t = distribute_tensor(torch.from_numpy(a).to(device), dmesh, pl, src_data_rank=None)
        return t.requires_grad_(grad) if grad else t

    rep_, model_shard = Replicate(), lambda d: Shard(d)
    with implicit_replication():
        if nll is not None:
            logits = put(nll["logits"], rep_, model_shard(2))
            rep.put("nll/loss", softmax_cross_entropy(logits, put(nll["labels"])))

        if seq is not None:
            cache = put(seq["cache"], rep_, model_shard(1))
            write_seq(cache, int(seq["start"]), put(seq["val"]))
            rep.put("seq/cache", cache)

        if product is not None:
            x, w = put(product["x"], grad=True), put(product["w"], grad=True)
            y = whole_product(x, w)
            torch.autograd.backward(y.square().sum())
            rep.put("product/y", y)
            rep.put("product/dx", x.grad)
            rep.put("product/dw", w.grad)

        if flash is not None:
            q = put(flash["q"], rep_, model_shard(1), grad=True)
            k, v = put(flash["k"], grad=True), put(flash["v"], grad=True)
            out = flash_attention(q, k, v, causal=True)
            torch.autograd.backward(out, put(flash["dout"], rep_, model_shard(1)))
            rep.put("flash/out", out)
            for name, t in (("dq", q), ("dk", k), ("dv", v)):
                rep.put(f"flash/{name}", t.grad)

        if ssd is not None:
            xs = put(ssd["x"], rep_, model_shard(2), grad=True)
            dts = put(ssd["dt"], rep_, model_shard(2), grad=True)
            A, Bm, Cm = (put(ssd[n], grad=True) for n in ("A", "B", "C"))
            y, h = ssd_scan(xs, dts, A, Bm, Cm, chunk=int(ssd["chunk"]))
            torch.autograd.backward(y, put(ssd["dy"], rep_, model_shard(2)))
            rep.put("ssd/y", y)
            rep.put("ssd/h", h)
            for name, t in (("dx", xs), ("ddt", dts), ("dA", A), ("dB", Bm), ("dC", Cm)):
                rep.put(f"ssd/{name}", t.grad)

        if embed is not None:
            table = put(embed["table"], rep_, model_shard(0), grad=True)
            out = embed_lookup(table, put(embed["tokens"]))
            torch.autograd.backward(out, put(embed["dout"]))
            rep.put("embed/out", out)
            rep.put("embed/dtable", table.grad)

        if decode is not None:
            q = put(decode["q"])
            k, v = (put(decode[n], rep_, model_shard(2)) for n in ("k", "v"))
            rep.put("decode/out", decode_attention(q, k, v, int(decode["kv_len"])))

        if slstm is not None:
            from types import SimpleNamespace

            from ..models.ssm import _slstm_local
            cfg = SimpleNamespace(n_heads=int(slstm["nh"]), d_model=slstm["pre"].shape[-1] // 4)
            pre = put(slstm["pre"], Shard(0), grad=True)
            r_h = put(slstm["r_h"], grad=True)
            hs, _ = _slstm_local({"r_h": r_h}, cfg, pre, "train")
            torch.autograd.backward(hs, put(slstm["dout"], Shard(0)))
            rep.put("slstm/hs", hs)
            rep.put("slstm/dpre", pre.grad)
            rep.put("slstm/dr_h", r_h.grad)

        if moe is not None:
            from ..models.mlp import slot_positions
            top_e = put(moe["top_e"], rep_, model_shard(0))
            rep.put("moe/positions", slot_positions(top_e, int(moe["n_experts"])))

        if mla is not None:
            from ..models.attention import mla_forward
            cache = {n: put(mla[n], rep_, model_shard(1)) for n in ("ckv", "krope")}
            x, kv_len = put(mla["x"]), int(mla["kv_len"])
            out, _ = mla_forward({k: put(v) for k, v in mla["params"].items()},
                                 config_of(mla["arch"]), x,
                                 torch.arange(x.shape[1], device=device) + kv_len,
                                 mode="decode", cache=cache, kv_len=kv_len)
            rep.put("mla/out", out)
            for n in ("ckv", "krope"):
                rep.put(f"mla/{n}", cache[n])

    return rep.out


JOBS = {"steps": steps_job, "train_loop": train_loop_job, "collectives": collectives_job,
        "faults": faults_job}


def run_jobs(world, device, jobs: list) -> list:
    """The spawnable body: every job of ``jobs`` (dicts with a ``"kind"``
    of :data:`JOBS` and that function's keyword arguments) on this rank,
    in order, each result with its host-clock seconds as ``"job_s"``.  On
    the card each job's cached blocks go back to the card after it, for
    the ranks that share it."""
    out = []
    for job in jobs:
        t0 = time.perf_counter()
        out.append(JOBS[job["kind"]](world, device,
                                     **{k: v for k, v in job.items() if k != "kind"}))
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out[-1]["job_s"] = round(time.perf_counter() - t0, 1)
    return out
