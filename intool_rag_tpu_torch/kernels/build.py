"""Builds the port's CUDA kernels from the sources in this directory.

Each ``*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded through :mod:`ctypes`. Nothing is
built or loaded when this module is imported: :func:`load` builds on first
use, into ``kernels/_build/`` (ignored by git), keyed by a hash of the
source, the directory's ``*.cuh`` headers and the flags, so an edited
source rebuilds. A failed build raises with
the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "_build"
SOURCES = (
    "flat_partial_topk.cu", "bits_scan.cu", "quant_stochastic.cu", "flash_attention.cu",
    "flash_attention_bwd.cu", "deepseek_decode.cu",
)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # compiler output per source built by this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(source: str) -> Path:
    src = (KERNEL_DIR / source).read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(KERNEL_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def _build(source: str, target: Path) -> str:
    """Compile ``source`` into ``target``; returns the compiler output
    (register and shared-memory use from ``-Xptxas=-v``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_DIR / source)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source} (rc {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)
    return proc.stdout


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``source``. If it is not built yet, every
    library of :data:`SOURCES` that is missing is built with it: one ``nvcc``
    per source, all started together."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            target = _target(source)
            if not target.exists():
                missing = [s for s in dict.fromkeys((source, *SOURCES)) if not _target(s).exists()]
                with ThreadPoolExecutor(max_workers=len(missing)) as pool:
                    logs = list(pool.map(lambda s: _build(s, _target(s)), missing))
                BUILD_LOG.update(zip(missing, logs))
            lib = ctypes.CDLL(str(target))
            _loaded[source] = lib
        return lib
