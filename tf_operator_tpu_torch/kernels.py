"""Build and load the port's hand-written CUDA kernels.

Each source under csrc/ has a plain C interface and is compiled by `nvcc`
into its own shared library, loaded with ctypes.  Builds happen at first
use, on the machine with the card (nothing here runs `nvcc` at import),
into `_build/` beside this file — a directory .gitignore lists — under a
name keyed by the hash of the source and the flags, so an edited source
rebuilds and an unchanged one is reused.  `build_all` starts one `nvcc`
per source at once and waits for them together.
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
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("paged_attention",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# nvcc's output per source from the last build in this process (ptxas's
# register, shared-memory and spill report rides in it)
build_logs: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: `nvcc` on PATH, else under CUDA_HOME
    (default /usr/local/cuda)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels are "
        "built on the machine with the card")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that has no library yet, one `nvcc`
    process per source, all started together.  Returns seconds per
    source built (an empty dict when everything was already built).
    Raises RuntimeError with nvcc's output when a build fails."""
    compiler = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        compiler = compiler or nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    seconds = {}
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):"
                          f"\n{out}")
            continue
        os.replace(tmp, lib)  # atomic: a reader never sees a partial .so
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it first if
    needed.  One load per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
