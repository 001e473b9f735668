"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each library is compiled at first use from the ``.cu`` files in
``ceres_tpu_torch/csrc/`` into ``ceres_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of its sources and flags so an edited
source never loads a stale binary. The sources expose a plain C interface;
no PyTorch header is compiled, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()  # guards _locks
_locks: dict = {}  # one lock per library: different libraries build in parallel
_loaded: dict = {}
# Seconds spent compiling each library in this process (0.0 when it was
# already built on disk).
build_seconds: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of ceres_tpu_torch are built from source at first use"
    )


def load_library(name: str, sources) -> ctypes.CDLL:
    """Compile ``sources`` (file names under csrc/) into one shared
    library, once per process and per source hash, and load it. Threads
    loading different libraries compile at the same time."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        paths = [CSRC / s for s in sources]
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in paths:
            digest.update(p.read_bytes())
        target = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)],
                    capture_output=True,
                    text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed building {name}:\n{proc.stderr}"
                    )
                os.replace(tmp, target)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        build_seconds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        _loaded[name] = lib
        return lib


def build_in_parallel(build_functions) -> None:
    """Run the given ``build_kernel`` callables at the same time, one nvcc
    each; the first failure is raised after all have ended."""
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as exc:  # raised again below, in the caller's thread
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(fn,)) for fn in build_functions]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
