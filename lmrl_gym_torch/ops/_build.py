"""Build the port's CUDA kernels with `nvcc` and load them with `ctypes`.

Each `csrc/<name>.cu` exposes a plain C interface and compiles, on its own,
into `build/kernels/<name>-<hash>.so` beside the package (the directory is
git-ignored); sources may include the shared headers `csrc/*.cuh`. The
hash covers the source, every header and the flags, so an edited kernel is
rebuilt and a stale library is never loaded. Nothing is built
when a module is imported: `load` builds at first use, and
`build_all` starts one `nvcc` per source, all at once, for callers that
want every kernel ready up front.

Libraries target `sm_90a` (Hopper). The build needs `nvcc` (found on
`PATH`, under `$CUDA_HOME/bin`, or at `/usr/local/cuda/bin`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("lmrl_gym_torch: nvcc not found; the CUDA kernels cannot be built")
    return path


def _source(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [_source(name)] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every listed kernel that is not built yet, one `nvcc` per
    source, all started together. Returns {name: ptxas report} for the
    sources compiled in this call. Raises with nvcc's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _source(name)]
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append((name, out, tmp, p))
    reports: Dict[str, str] = {}
    failed: List[str] = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"--- nvcc {name} (rc {p.returncode})\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        reports[name] = log
    if failed:
        raise RuntimeError("lmrl_gym_torch: kernel build failed\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib
