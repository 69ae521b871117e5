"""Build and load the pointer kernels' CUDA sources, and count launches.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``.  A library's file name
carries a hash of its sources and flags, so an edited source never reuses a
stale build.  Builds go to ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``) at first use; :func:`build_kernels` starts one
``nvcc`` per missing library, all at once.

:data:`LAUNCHES` counts, per kernel, the launches its wrapper has made.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["LAUNCHES", "KERNELS", "BUILD_DIR", "build_kernels", "load_function", "check"]

#: launches per kernel, bumped by each wrapper right after a successful launch
LAUNCHES: dict[str, int] = {"ptr_step": 0, "ptr_decode": 0}

#: kernel name -> its source file under csrc/
KERNELS = {"ptr_step": "ptr_step.cu", "ptr_decode": "ptr_decode.cu"}

CSRC = Path(__file__).resolve().parent / "csrc"
_HEADERS = ("ptr_common.cuh",)
# src/repro_torch/kernels/ptr/build.py -> repository root
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return str(path)


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (KERNELS[name],) + _HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_kernels(names=None) -> float:
    """Compile the named kernels (default: all) that have no current build,
    one ``nvcc`` process each, all started together.  Returns the seconds
    spent; raises with the compiler's output if a build fails."""
    names = list(KERNELS) if names is None else list(names)
    todo = [nm for nm in names if not library_path(nm).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for nm in todo:
        final = library_path(nm)
        tmp = final.with_name(f"{final.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[nm])]
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
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def load_function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of kernel library ``name`` (built if
    needed), with its argument types set; it returns an int error code."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_kernels([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.ptr_error_string.argtypes = [ctypes.c_int]
            lib.ptr_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = _libs[name].ptr_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")
