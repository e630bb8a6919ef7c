"""Build the port's CUDA sources into shared libraries and load them.

Each library is compiled at first use with ``nvcc`` for ``sm_90a`` (the
H100: ``wgmma`` and ``setmaxnreg`` exist only for the ``a`` target) into
``build/kernels/`` at the repository root, under a name keyed by a hash of
its sources and flags, so an edited source rebuilds and an unchanged one
loads the cached file. The libraries expose plain C functions that the op
wrappers call through :mod:`ctypes`; nothing here includes PyTorch's
headers, which keeps a build to seconds.

Nothing is compiled when a module is imported: the CPU tests import every
module on hosts with no ``nvcc``. :func:`load_libraries` starts one
``nvcc`` per library, all at once; ``load_libraries(LIBRARIES)`` builds
them all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: Every kernel library of the port: name -> its sources under ``csrc/``
#: (which may include the headers there).
LIBRARIES = {
    "flash_fwd": ["flash_fwd.cu"],
    "flash_bwd": ["flash_bwd.cu"],
    "pointwise_conv": ["pointwise_conv.cu"],
    "fused_conv_bn": ["fused_conv_bn.cu"],
}

_LOCK = threading.Lock()
_NAME_LOCKS: dict[str, threading.Lock] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
#: per library: {"path", "seconds" (0.0 when loaded from the cache), "log"
#: (nvcc's output, ptxas' ``-v`` lines included, also for a cached load)}
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels build "
        "on a host with the CUDA toolkit"
    )


def load_library(name: str, sources: list[str]) -> ctypes.CDLL:
    """Compile ``sources`` (file names under ``csrc/``) into ``lib<name>``
    unless a build of the same sources exists, then load it (once).
    Builds of different libraries run concurrently."""
    with _LOCK:
        name_lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with name_lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        paths = [CSRC / s for s in sources]
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in paths + sorted(CSRC.glob("*.cuh")):
            h.update(p.read_bytes())
        out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
        log_file = out.with_suffix(".log")  # nvcc's output, kept for a cached load
        seconds, log = 0.0, ""
        if out.exists() and log_file.exists():
            log = log_file.read_text()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
            t0 = time.monotonic()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.monotonic() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            log_file.write_text(log)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        BUILD_INFO[name] = {"path": str(out), "seconds": seconds, "log": log}
        _LIBS[name] = lib
        return lib


def load_libraries(specs: dict[str, list[str]]) -> dict[str, ctypes.CDLL]:
    """:func:`load_library` for each ``name: sources`` entry, one ``nvcc``
    per library, all started together."""
    with ThreadPoolExecutor(max_workers=max(1, len(specs))) as pool:
        futures = {name: pool.submit(load_library, name, srcs)
                   for name, srcs in specs.items()}
        return {name: f.result() for name, f in futures.items()}
