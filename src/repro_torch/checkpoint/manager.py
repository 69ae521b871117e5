"""The checkpoint directory format, both sides, and the trainer's
:class:`CheckpointManager`.

    <dir>/manifest.json     # {"leaves": [{"name", "file", "shape", "dtype"}, ...],
                            #  "treedef": "PyTreeDef({...})"}
    <dir>/arr_0000.bin ...  # one raw little-endian buffer per leaf

A bfloat16 leaf is stored as its raw two-byte words under the dtype name
``bfloat16``, as the reference writes it (numpy has no bfloat16 of its
own: in memory such a leaf is a numpy array of :data:`BF16`, a 2-byte
record).

Leaf names are dict keys joined by slashes, in sorted key order (JAX's
``tree_flatten_with_path`` order), so a tree of nested dicts rebuilds from
the manifest alone and the reference's readers (``repro.checkpoint``) read
what :func:`save_pytree` writes, and the other way round.  ``treedef`` is
written for the same manifest keys; no reader uses it.  A None leaf is an
empty subtree, as in JAX (an optimizer state without master copies).

    <ckpt>/step_00000123.tmp/   # CheckpointManager: written first
    <ckpt>/step_00000123/       # renamed when complete
    <ckpt>/LATEST               # name of the newest complete step

:class:`CheckpointManager` keeps that layout, the reference's: the rename
is the commit (restore ignores ``.tmp`` directories), ``save(...,
blocking=False)`` copies the tree to the host at once and writes it on a
thread, and the ``keep`` newest steps are retained.  A trainer state saved
by either package restores in the other (the leaf names are the
reference's ``tree_flatten_with_path`` names).

Sharded trees (the reference's reshard-on-load).  A tree with ``DTensor``
leaves is gathered by every rank (a collective), written by rank 0 alone
before ``save`` returns (a sharded save is always blocking), and every rank
then waits at a barrier, so each one sees the step once ``save`` returns.
The files are the same as a single device's.  ``load_pytree``,
``restore`` and ``restore_latest`` take ``shardings`` (a tree of
:class:`~repro_torch.parallel.sharding.NamedSharding` on a ``DeviceMesh``,
of the target's structure): each rank reads the full leaves and keeps its
shard at the target's placements, whatever mesh wrote them; a ``DTensor``
leaf of the target without a sharding keeps its own placements.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

__all__ = ["BF16", "CheckpointManager", "flatten_leaves", "is_checkpoint_dir", "load_pytree",
           "load_pytree_dict", "read_leaves", "save_pytree"]

#: the host copy of a bfloat16 leaf: its raw 16-bit words
BF16 = np.dtype([("bfloat16", "<u2")])


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == BF16 else str(arr.dtype)


def flatten_leaves(tree: dict, prefix: str = "") -> list[tuple[str, np.ndarray]]:
    """(slash-joined name, numpy array) of every leaf of a tree of nested
    dicts, keys sorted at each level; tensor leaves are copied to the host
    (a bfloat16 one as an array of :data:`BF16`)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if v is None:
            continue
        if isinstance(v, dict):
            out += flatten_leaves(v, f"{prefix}{k}/")
        elif isinstance(v, torch.Tensor):
            out.append((prefix + str(k), _numpy(v)))
        else:
            out.append((prefix + str(k), np.asarray(v)))
    return out


def _treedef(tree: dict) -> str:
    def rec(t):
        return "{" + ", ".join(f"{k!r}: {rec(t[k]) if isinstance(t[k], dict) else '*'}"
                               for k in sorted(t) if t[k] is not None) + "}"
    return f"PyTreeDef({rec(tree)})"


def _is_sharded(tree) -> bool:
    if isinstance(tree, dict):
        return any(_is_sharded(v) for v in tree.values())
    return hasattr(tree, "device_mesh")


def _writer() -> bool:
    """This process writes: rank 0 of an initialised world, or no world."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist
    dist.barrier()


def save_pytree(tree: dict, directory: str | Path) -> None:
    """Write a tree of nested dicts (numpy arrays or tensors as leaves) to
    ``directory`` atomically: into ``<directory>.tmp`` first (a stale one is
    removed), then renamed over ``directory``.  A tree of ``DTensor``s is
    gathered by every rank and written by rank 0; every rank returns after
    the rename."""
    if _is_sharded(tree):
        host = _gathered_host_copy(tree)
        if _writer():
            save_pytree(host, directory)
        _barrier()
        return
    directory = Path(directory)
    tmp = directory.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"leaves": [], "treedef": _treedef(tree)}
    for i, (name, leaf) in enumerate(flatten_leaves(tree)):
        arr = np.asarray(leaf, order="C")   # keeps 0-d leaves 0-d
        fname = f"arr_{i:04d}.bin"
        (tmp / fname).write_bytes(arr.tobytes())
        manifest["leaves"].append({"name": name, "file": fname, "shape": list(arr.shape),
                                   "dtype": _dtype_name(arr)})
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if directory.exists():
        shutil.rmtree(directory)
    tmp.rename(directory)


def _read_array(path: Path, entry: dict) -> np.ndarray:
    dtype = BF16 if entry["dtype"] == "bfloat16" else np.dtype(entry["dtype"])
    arr = np.frombuffer(path.read_bytes(), dtype=dtype)
    return arr.reshape(entry["shape"])


def is_checkpoint_dir(path: str | Path) -> bool:
    return (Path(path) / "manifest.json").exists()


def read_leaves(directory: str | Path) -> dict[str, np.ndarray]:
    """Leaf name -> numpy array (read-only views of the stored bytes)."""
    directory = Path(directory)
    manifest = json.loads((directory / "manifest.json").read_text())
    return {e["name"]: _read_array(directory / e["file"], e) for e in manifest["leaves"]}


def load_pytree_dict(directory: str | Path) -> dict:
    """Nested dict of CPU torch tensors rebuilt from the slash-joined leaf
    names.  A truncated buffer or a bad manifest entry raises."""
    out: dict = {}
    for name, arr in read_leaves(directory).items():
        parts = name.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = _tensor(arr)
    return out


def load_pytree(directory: str | Path, target: dict, shardings=None) -> dict:
    """Restore into the structure of ``target`` (nested dicts of tensors;
    their values are ignored): each leaf read by its slash-joined name,
    cast to the target leaf's dtype and put on its device; with
    ``shardings`` (a tree of ``NamedSharding`` like ``target``), or where
    the target leaf is a ``DTensor``, as a ``DTensor`` of which this rank
    keeps its shard.  A missing leaf or a shape that differs raises."""
    stored = read_leaves(directory)

    def rec(t, sh, prefix):
        out = {}
        for k in sorted(t):
            v = t[k]
            if v is None:
                out[k] = None
            elif isinstance(v, dict):
                out[k] = rec(v, None if sh is None else sh[k], f"{prefix}{k}/")
            else:
                name = prefix + str(k)
                if name not in stored:
                    raise KeyError(f"checkpoint missing leaf {name!r}")
                arr = stored[name]
                if tuple(arr.shape) != tuple(v.shape):
                    raise ValueError(f"shape mismatch for {name}: checkpoint {arr.shape} "
                                     f"vs {tuple(v.shape)}")
                out[k] = _placed(arr, v, None if sh is None else sh[k])
        return out

    return rec(target, shardings, "")


def _placed(arr: np.ndarray, like, sharding):
    """The stored ``arr`` in ``like``'s dtype, on its device, or as a
    ``DTensor`` at ``sharding`` (else at ``like``'s placements where it is
    one), of which this rank reads and keeps only its own region."""
    if sharding is not None:
        mesh, placements = sharding.mesh, tuple(sharding.placements)
    elif hasattr(like, "device_mesh"):
        mesh, placements = like.device_mesh, tuple(like.placements)
    else:
        return _tensor(arr).to(device=like.device, dtype=like.dtype)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from ..parallel.sharding import mesh_device
    shape, off = compute_local_shape_and_global_offset(arr.shape, mesh, placements)
    region = np.ascontiguousarray(arr[tuple(slice(o, o + n) for o, n in zip(off, shape))])
    local = _tensor(region.reshape(shape)).to(device=mesh_device(mesh), dtype=like.dtype)
    full = torch.empty(arr.shape, dtype=like.dtype, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=full.shape,
                              stride=full.stride())


def _gathered_host_copy(tree):
    """A tree of ``DTensor``s gathered leaf by leaf (every rank takes part
    in each gather); the writer keeps each full leaf's host copy, the other
    ranks None."""
    if isinstance(tree, dict):
        return {k: _gathered_host_copy(v) for k, v in tree.items()}
    if tree is None:
        return None
    full = tree.full_tensor() if hasattr(tree, "device_mesh") else tree
    return _host_copy(full) if _writer() else None


def _host_copy(tree):
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return _numpy(tree).copy()
    return None if tree is None else np.array(tree)


class CheckpointManager:
    """Step directories under ``directory`` with ``LATEST``, retention of
    the ``keep`` newest, and saves on a background thread."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _step_dir(self, step: int) -> Path:
        return self.directory / f"step_{step:08d}"

    def save(self, step: int, tree: dict, blocking: bool = True) -> None:
        """Write ``tree`` as step ``step``.  The tree is copied to the host
        before this returns; with ``blocking=False`` the files are written
        on a thread (one save in flight: a second one waits).  A tree of
        ``DTensor``s is gathered and written by rank 0 before this returns
        on every rank."""
        self.wait()
        if _is_sharded(tree):
            host_tree = _gathered_host_copy(tree)
            if _writer():
                save_pytree(host_tree, self._step_dir(step))
                (self.directory / "LATEST").write_text(self._step_dir(step).name)
                self._gc()
            _barrier()
            return
        host_tree = _host_copy(tree)

        def write():
            save_pytree(host_tree, self._step_dir(step))
            (self.directory / "LATEST").write_text(self._step_dir(step).name)
            self._gc()

        if blocking:
            write()
            return

        def run():
            try:
                write()
            except BaseException as e:     # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the save in flight is written; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self) -> list[int]:
        """Steps with a complete directory, ascending (``.tmp`` ignored)."""
        out = []
        for p in self.directory.glob("step_*"):
            if p.suffix == ".tmp" or not is_checkpoint_dir(p):
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: dict, shardings=None) -> dict:
        return load_pytree(self._step_dir(step), target, shardings)

    def restore_latest(self, target: dict, shardings=None):
        """(step, tree) of the newest complete step, or (None, None)."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target, shardings)
