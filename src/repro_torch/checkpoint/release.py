"""Versioned release checkpoints of the trained RESPECT agent.

    checkpoints/respect-v1/
        release.json        # version, config, provenance, params_sha256
        params/             # checkpoint directory (see .manager)

:func:`verify_release` recomputes the parameter digest from the stored
buffers — the same sha256 as the reference's ``repro.checkpoint.release``
— and rejects a missing, ill-formed, truncated or edited release with
:class:`ReleaseError`.  :func:`write_release` stages a release beside its
target and publishes it with one rename, as the reference's does; a release
written by either package verifies in both.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import warnings
from pathlib import Path

import numpy as np

from .manager import flatten_leaves, is_checkpoint_dir, load_pytree_dict, save_pytree

__all__ = [
    "ReleaseError",
    "params_sha256",
    "verify_release",
    "find_release",
    "load_release_params",
    "warn_no_release",
    "write_release",
    "RELEASE_MANIFEST",
    "REQUIRED_MANIFEST_KEYS",
]

RELEASE_MANIFEST = "release.json"
PARAMS_SUBDIR = "params"
REQUIRED_MANIFEST_KEYS = ("schema_version", "version", "params_sha256", "config", "train")
_VERSION_RE = re.compile(r"^respect-v(\d+)$")


class ReleaseError(RuntimeError):
    """A release checkpoint failed schema or integrity verification."""


def params_sha256(params: dict) -> str:
    """sha256 over the leaves sorted by slash-joined name: per leaf the name,
    ``str(dtype)`` and ``repr(shape)`` (numpy spellings) and the raw bytes.
    Leaves may be torch tensors (on any device) or numpy arrays."""
    h = hashlib.sha256()
    for name, arr in sorted(flatten_leaves(params), key=lambda kv: kv[0]):
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(repr(tuple(arr.shape)).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def verify_release(directory: str | Path) -> tuple[dict, dict]:
    """Load and integrity-check one release; returns (params, manifest) with
    params as a nested dict of CPU torch tensors."""
    directory = Path(directory)
    mpath = directory / RELEASE_MANIFEST
    if not mpath.exists():
        raise ReleaseError(f"no {RELEASE_MANIFEST} under {directory}")
    try:
        manifest = json.loads(mpath.read_text())
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ReleaseError(f"unparseable {mpath}: {e}") from e
    missing = [k for k in REQUIRED_MANIFEST_KEYS if k not in manifest]
    if missing:
        raise ReleaseError(f"{mpath} missing required keys: {missing}")
    pdir = directory / PARAMS_SUBDIR
    if not is_checkpoint_dir(pdir):
        raise ReleaseError(f"{pdir} is not a checkpoint directory")
    try:
        params = load_pytree_dict(pdir)
    except (OSError, ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
        raise ReleaseError(f"unreadable params under {pdir}: {e}") from e
    digest = params_sha256(params)
    if digest != manifest["params_sha256"]:
        raise ReleaseError(
            f"params digest mismatch under {directory}: manifest pins "
            f"{manifest['params_sha256'][:16]}..., stored buffers hash to "
            f"{digest[:16]}... — the checkpoint is corrupt or was edited")
    return params, manifest


def _fsync_path(path: Path) -> None:
    """fsync one file or directory by descriptor."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_release(params: dict, directory: str | Path, meta: dict) -> dict:
    """Write a release: ``params`` (a tree of tensors or numpy arrays, e.g.
    :func:`repro_torch.core.ptrnet.param_tree` of a trained net) under
    ``params/`` and ``release.json`` with the digest stamped in.  ``meta``
    carries ``version``, ``config`` and ``train``; returns the manifest.

    Everything is staged in ``<name>.tmp`` (each file and directory
    fsynced), then published with ``os.replace`` and an fsync of the
    parent, so a crash leaves the previous release or none, never a half
    written one that :func:`find_release` could discover."""
    directory = Path(directory)
    directory.parent.mkdir(parents=True, exist_ok=True)
    manifest = dict(meta)
    manifest.setdefault("schema_version", 1)
    manifest["params_sha256"] = params_sha256(params)
    missing = [k for k in REQUIRED_MANIFEST_KEYS if k not in manifest]
    if missing:
        raise ReleaseError(f"release meta missing keys: {missing}")
    stage = directory.with_name(directory.name + ".tmp")
    if stage.exists():
        shutil.rmtree(stage)
    stage.mkdir(parents=True)
    try:
        save_pytree(params, stage / PARAMS_SUBDIR)
        with open(stage / RELEASE_MANIFEST, "w") as f:
            f.write(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
        for p in sorted(stage.rglob("*")):
            _fsync_path(p)
        _fsync_path(stage)
        if directory.exists():
            shutil.rmtree(directory)
        os.replace(stage, directory)
        _fsync_path(directory.parent)
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise
    return manifest


def _default_root() -> Path:
    # src/repro_torch/checkpoint/release.py -> repo root
    return Path(__file__).resolve().parents[3] / "checkpoints"


def find_release(root: str | Path | None = None) -> Path | None:
    """Newest ``respect-v<N>`` release directory, or None.

    ``$RESPECT_CHECKPOINT`` overrides discovery: a release directory pins
    that one, a path without a release forces the seeded fallback.
    """
    env = os.environ.get("RESPECT_CHECKPOINT")
    if env is not None:
        p = Path(env)
        return p if (p / RELEASE_MANIFEST).exists() else None
    root = Path(root) if root is not None else _default_root()
    if not root.exists():
        return None
    best: tuple[int, Path] | None = None
    for p in root.iterdir():
        m = _VERSION_RE.match(p.name)
        if m and (p / RELEASE_MANIFEST).exists():
            v = int(m.group(1))
            if best is None or v > best[0]:
                best = (v, p)
    return None if best is None else best[1]


def load_release_params(path: str | Path | None = None, root: str | Path | None = None):
    """(params, manifest) for ``path`` or the newest discovered release;
    (None, None) when no release exists.  An existing but corrupt release
    raises."""
    if path is None:
        path = find_release(root)
        if path is None:
            return None, None
    return verify_release(path)


def warn_no_release(context: str) -> None:
    warnings.warn(
        f"{context}: no trained release checkpoint found under checkpoints/ "
        "(or $RESPECT_CHECKPOINT) — falling back to the seeded untrained agent.",
        RuntimeWarning, stacklevel=3)
