"""Read side of the checkpoint directory format.

    <dir>/manifest.json     # {"leaves": [{"name", "file", "shape", "dtype"}, ...]}
    <dir>/arr_0000.bin ...  # one raw little-endian buffer per leaf

Leaf names are dict keys joined by slashes, so a tree of nested dicts
rebuilds from the manifest alone.  The reference (``repro.checkpoint``)
writes this format; writing it from the port waits for its training code.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

__all__ = ["is_checkpoint_dir", "load_pytree_dict", "read_leaves"]


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
