"""Build and load the port's CUDA kernels, and count their launches.

Every kernel — the pointer kernels (``ptr/csrc``), flash attention
(``flash/csrc``) and the SSD scan (``ssd/csrc``) — compiles with ``nvcc``
into its own shared library with a plain C interface, loaded with
``ctypes``; each exports ``kernel_error_string``, which names a CUDA error
code.  A library's file name carries a hash of its sources and flags,
so an edited source never reuses a stale build.  Builds go to
``build/repro_torch/`` at the repository root (listed in ``.gitignore``) at
first use; :func:`build_kernels` starts one ``nvcc`` per missing library,
all at once.  A script may load an instrumented variant of a library, built
with extra ``-D`` defines beside the plain one (``load_function(...,
defines=...)``).

:data:`LAUNCHES` counts, per kernel, the launches its wrapper has made; a
library whose launcher picks one of several kernels (``ptr_decode``) counts
each of them under its own name.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "KERNELS", "BUILD_DIR", "KernelError", "build_kernels", "refuse_dtensor",
           "refuse_grad", "load_function", "check"]


class KernelError(RuntimeError):
    """A kernel could not be built, loaded or launched.  Running the same
    work again, on the same card, fails the same way, so callers let it
    propagate rather than retry or move the work elsewhere."""


@dataclasses.dataclass(frozen=True)
class KernelSource:
    subdir: str            # kernels/<subdir>/csrc
    source: str            # the .cu file
    headers: tuple = ()    # headers it includes from the same csrc/
    counted: tuple = ()    # the kernels counted apart in LAUNCHES (default: the library's name)


_PTR = ("ptr_common.cuh",)
#: kernel name -> its sources
KERNELS = {
    "ptr_step": KernelSource("ptr", "ptr_step.cu", _PTR),
    "ptr_decode": KernelSource("ptr", "ptr_decode.cu", _PTR,
                               ("ptr_decode_cluster", "ptr_decode_block",
                                "ptr_decode_cluster_bf16", "ptr_decode_block_bf16",
                                "ptr_decode_wide_f32", "ptr_decode_wide_bf16")),
    "flash_fwd": KernelSource("flash", "flash_fwd.cu"),
    "ssd_scan": KernelSource("ssd", "ssd_scan.cu"),
}

#: launches per kernel, bumped by each wrapper right after a successful launch
LAUNCHES: dict[str, int] = {k: 0 for name, src in KERNELS.items() for k in src.counted or (name,)}

_KERNELS_DIR = Path(__file__).resolve().parent
# src/repro_torch/kernels/build.py -> repository root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _csrc(name: str) -> Path:
    return _KERNELS_DIR / KERNELS[name].subdir / "csrc"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise KernelError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return str(path)


def _flags(defines: tuple) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: tuple = ()) -> Path:
    k = KERNELS[name]
    h = hashlib.sha256()
    for f in (k.source,) + k.headers:
        h.update((_csrc(name) / f).read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_kernels(names=None, defines: tuple = ()) -> float:
    """Compile the named kernels (default: all) that have no current build,
    one ``nvcc`` process each, all started together, each with the extra
    ``-D`` ``defines``.  Returns the seconds spent; raises with the
    compiler's output if a build fails."""
    names = list(KERNELS) if names is None else list(names)
    todo = [nm for nm in names if not library_path(nm, defines).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for nm in todo:
        final = library_path(nm, defines)
        tmp = final.with_name(f"{final.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(defines), "-o", str(tmp), str(_csrc(nm) / KERNELS[nm].source)]
        procs.append((nm, tmp, final, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for nm, tmp, final, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{nm}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, final)   # atomic: readers never see a partial file
    if failures:
        raise KernelError("kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def load_function(name: str, symbol: str, argtypes: list,
                  defines: tuple = ()) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of kernel library ``name`` (built with the
    extra ``-D`` ``defines`` if needed), with its argument types set; it
    returns an int error code."""
    key = (name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build_kernels([name], defines)
            try:
                lib = ctypes.CDLL(str(library_path(name, defines)))
            except OSError as exc:
                raise KernelError(f"{name}: cannot load its library: {exc}") from exc
            err = lib.kernel_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[key] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, code: int) -> None:
    """Raise if a launcher of library ``name`` returned a CUDA error code."""
    if code != 0:
        lib = next(lib for (nm, _), lib in _libs.items() if nm == name)
        msg = lib.kernel_error_string(code).decode()
        raise KernelError(f"{name} kernel launch failed: CUDA error {code} ({msg})")


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise when any of ``tensors`` is a ``DTensor``: a launcher reads raw
    device pointers, so it takes one rank's local tensors only
    (:func:`repro_torch.kernels.sharded.on_shards` passes them)."""
    if any(hasattr(t, "device_mesh") for t in tensors):
        raise TypeError(f"{name} takes a rank's local tensors, not DTensors; call it through "
                        "repro_torch.kernels.sharded.on_shards")


def refuse_grad(name: str, hint: str, *tensors) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad: a
    kernel's output carries no autograd history, so a loss built on it
    would lose every gradient through it without an error.  ``hint`` says
    where the differentiable route is."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: an input requires grad, and the kernel's output carries "
                           f"no gradient; {hint}")
