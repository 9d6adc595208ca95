"""Build and load the hand-written CUDA kernels (kubernetes_tpu_torch/csrc).

Each kernel source compiles with nvcc into its own shared library with a
plain C interface, loaded with ctypes: no PyTorch headers, so a build
takes seconds. Libraries land in kubernetes_tpu_torch/build/ under a name
that carries a digest of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. All sources build in parallel,
one nvcc process each, at first use (never at import: the CPU-only test
environment has no nvcc).
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
from typing import Dict

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

#: kernel name -> source file (each includes csrc/*.cuh as needed)
SOURCES = {"class_ms_init": "class_ms_init.cu",
           "class_scan": "class_scan.cu",
           "apply_dirty": "apply_dirty.cu",
           "drf_dominant": "drf_dominant.cu",
           "drf_order": "drf_order.cu",
           "price_nodes": "price_nodes.cu",
           "pod_scan": "pod_scan.cu",
           "filter_score": "filter_score.cu",
           "gang_scan": "gang_scan.cu",
           "gang_feasible": "gang_feasible.cu",
           "price_domains": "price_domains.cu",
           "spec_scan": "spec_scan.cu",
           "affinity_masks": "affinity_masks.cu",
           "affinity_scores": "affinity_scores.cu"}

#: sm_90a (Hopper); -fmad=false keeps every multiply and add separately
#: rounded, as the f32 reference computes them
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "kubernetes_tpu_torch need the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC_DIR / SOURCES[name]).read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all(verbose: bool = False) -> Dict[str, dict]:
    """Compile every kernel library that is not built yet, all nvcc
    processes started together. Returns {name: {"path", "seconds",
    "log"}} for every kernel (seconds 0.0 where the library existed).
    Raises RuntimeError with nvcc's output when a build fails."""
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name, src in SOURCES.items():
        # the library name hashes the default flags: -Xptxas -v changes
        # only what nvcc prints, not the code
        path = library_path(name)
        if path.exists() and not verbose:
            out[name] = {"path": str(path), "seconds": 0.0, "log": ""}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *flags, "-o", str(tmp), str(CSRC_DIR / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()   # every process ends before a raise
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[name]} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)   # atomic: a reader never sees half a file
        out[name] = {"path": str(path),
                     "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library, building every library
    on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
