"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers, so
one ``nvcc`` call builds it in seconds:

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas=-v
       -shared -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so
       csrc/<name>.cu

The toolkit must be CUDA 12.5 or later: ``flash_attention.cu`` takes
``cuTensorMapEncodeTiled`` from ``cudaGetDriverEntryPointByVersion`` and
refuses to compile on an older one.

The library lands in ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads the library already built. It is loaded with ``ctypes``. Nothing here
runs when a module is imported: the CPU tests import every module on
machines without ``nvcc``.

Concurrent first uses may both compile; each writes a private file and
renames it into place atomically, so a reader never loads half a library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}
#: seconds each library took to build in this process (0.0 when it was
#: found already built), and what nvcc printed (ptxas: registers, spills,
#: shared memory per kernel), also kept beside the library as ``.log``
BUILD_SECONDS: Dict[str, float] = {}
BUILD_LOG: Dict[str, str] = {}
#: ``build/kernels/`` at the repository root (listed in ``.gitignore``)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def compile_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags is already built; returns the library's path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists():   # keeps the time of a build made earlier in this process
        BUILD_SECONDS.setdefault(name, 0.0)
        if name not in BUILD_LOG and log.exists():
            BUILD_LOG[name] = log.read_text()
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".lib{name}-{digest}.{os.getpid()}.so"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOG[name] = proc.stdout + proc.stderr
    log.write_text(BUILD_LOG[name])   # before the library, so a found library has its log
    os.replace(tmp, lib)
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(compile_library(name)))
    return lib
