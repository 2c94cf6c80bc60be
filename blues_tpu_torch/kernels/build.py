"""Compile the CUDA sources of the port at first use and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
into its own shared library under ``blues_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of its source, the shared ``csrc/*.cuh``
headers and the flags, so an edited kernel is rebuilt, then loaded with
``ctypes``. ``build_all`` starts one ``nvcc`` per source at once. Nothing
here runs at import time.
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


def _lib_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless its library exists; returns
    (process or None, temporary path, library path)."""
    lib_path = _lib_path(name)
    if lib_path.exists():
        return None, None, lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib_path


def _finish(name: str, proc, tmp, lib_path) -> ctypes.CDLL:
    if proc is not None:
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {CSRC_DIR / (name + '.cu')}:\n{out}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _loaded[name] = lib
    return lib


def build_all(names) -> dict:
    """Build (one nvcc per source, all started together) and load every
    ``csrc/<name>.cu`` of ``names``; returns {name: library}."""
    with _lock:
        todo = [n for n in names if n not in _loaded]
        started = []
        try:
            for n in todo:
                started.append((n, *_start(n)))
            for n, proc, tmp, lib_path in started:
                _finish(n, proc, tmp, lib_path)
        finally:
            for _, proc, _, _ in started:  # a failed build stops the others
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return {n: _loaded[n] for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    return build_all([name])[name]
