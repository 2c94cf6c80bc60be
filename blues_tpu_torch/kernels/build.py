"""Compile the CUDA sources of the port at first use and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
into its own shared library under ``blues_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of its source so an edited kernel is
rebuilt, then loaded with ``ctypes``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: dict = {}
#: nvcc's output (register / shared-memory report) per built source
build_logs: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        src = CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
        if not lib_path.exists():
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_logs[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        _loaded[name] = lib
        return lib
