"""The checkpoint directory format, both sides.

    <dir>/manifest.json     # {"leaves": [{"name", "file", "shape", "dtype"}, ...],
                            #  "treedef": "PyTreeDef({...})"}
    <dir>/arr_0000.bin ...  # one raw little-endian buffer per leaf

Leaf names are dict keys joined by slashes, in sorted key order (JAX's
``tree_flatten_with_path`` order), so a tree of nested dicts rebuilds from
the manifest alone and the reference's readers (``repro.checkpoint``) read
what :func:`save_pytree` writes, and the other way round.  ``treedef`` is
written for the same manifest keys; no reader uses it.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import torch

__all__ = ["flatten_leaves", "is_checkpoint_dir", "load_pytree_dict", "read_leaves",
           "save_pytree"]


def flatten_leaves(tree: dict, prefix: str = "") -> list[tuple[str, np.ndarray]]:
    """(slash-joined name, numpy array) of every leaf of a tree of nested
    dicts, keys sorted at each level; tensor leaves are copied to the host."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += flatten_leaves(v, f"{prefix}{k}/")
        elif isinstance(v, torch.Tensor):
            out.append((prefix + str(k), v.detach().cpu().numpy()))
        else:
            out.append((prefix + str(k), np.asarray(v)))
    return out


def _treedef(tree: dict) -> str:
    def rec(t):
        return "{" + ", ".join(f"{k!r}: {rec(t[k]) if isinstance(t[k], dict) else '*'}"
                               for k in sorted(t)) + "}"
    return f"PyTreeDef({rec(tree)})"


def save_pytree(tree: dict, directory: str | Path) -> None:
    """Write a tree of nested dicts (numpy arrays or tensors as leaves) to
    ``directory`` atomically: into ``<directory>.tmp`` first (a stale one is
    removed), then renamed over ``directory``."""
    directory = Path(directory)
    tmp = directory.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"leaves": [], "treedef": _treedef(tree)}
    for i, (name, leaf) in enumerate(flatten_leaves(tree)):
        arr = np.ascontiguousarray(leaf)
        fname = f"arr_{i:04d}.bin"
        (tmp / fname).write_bytes(arr.tobytes())
        manifest["leaves"].append({"name": name, "file": fname, "shape": list(arr.shape),
                                   "dtype": str(arr.dtype)})
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if directory.exists():
        shutil.rmtree(directory)
    tmp.rename(directory)


def _read_array(path: Path, entry: dict) -> np.ndarray:
    arr = np.frombuffer(path.read_bytes(), dtype=np.dtype(entry["dtype"]))
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
        d[parts[-1]] = torch.from_numpy(arr.copy())
    return out
