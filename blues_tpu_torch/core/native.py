"""The native fixed-width Amber tokenizer (``csrc/amber_io.cpp``), bound
with ctypes.

``g++ -O3 -shared -fPIC`` builds it at first use into
``blues_tpu_torch/_build/`` (git-ignored), under a name hashed from the
source and the flags, as ``kernels/build.py`` names the CUDA libraries, so
an edited source is rebuilt. It converts a fixed-width numeric section
30-100x faster than a Python loop. Where no host compiler exists the
loaders fall back to the pure-Python tokenizer, as the JAX package does;
``parse_fixed`` names the one that read its fields ("native" or "python"),
and ``Prmtop.tokenizer`` and the loader's log line report it. This is host
code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading

import numpy as np

from ..kernels.build import BUILD_DIR, CSRC_DIR

logger = logging.getLogger("blues_tpu_torch.native")

CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
_SRC = CSRC_DIR / "amber_io.cpp"
_lock = threading.Lock()
_lib = None
_tried = False


def library_path():
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libamber_io_{h.hexdigest()[:16]}.so"


def _build(path):
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no g++ on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)], check=True, capture_output=True, timeout=300)
    os.replace(tmp, path)


def get_lib():
    """The loaded library (built if needed), or None without a host compiler."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, ctype in (("parse_fixed_floats", ctypes.c_double), ("parse_fixed_ints", ctypes.c_int64)):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctype), ctypes.c_int64]
            _lib = lib
            logger.info("native Amber tokenizer: %s", path)
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:  # no compiler, a failed build or load
            logger.info("native Amber tokenizer unavailable (%s); using the Python tokenizer", exc)
        return _lib


def _native(text: str, width: int, integer: bool):
    lib = get_lib()
    if lib is None:
        return None
    data = text.encode()
    max_out = len(data) // max(width, 1) + 8
    dtype, ctype, fn = (
        (np.int64, ctypes.c_int64, lib.parse_fixed_ints)
        if integer
        else (np.float64, ctypes.c_double, lib.parse_fixed_floats)
    )
    out = np.empty(max_out, dtype)
    n = fn(data, len(data), width, out.ctypes.data_as(ctypes.POINTER(ctype)), max_out)
    return None if n < 0 else out[:n]


def python_fields(lines, width: int) -> list:
    """The non-blank ``width``-character fields of ``lines``, stripped."""
    out = []
    for line in lines:
        line = line.rstrip("\n")
        for i in range(0, len(line.rstrip()), width):
            chunk = line[i : i + width].strip()
            if chunk:
                out.append(chunk)
    return out


def parse_fixed(lines, width: int, integer: bool = False):
    """(the numeric ``width``-wide fields of ``lines`` as int64
    (``integer``) or float64, the tokenizer that read them): the native one
    unless it is unavailable or its buffer overflows, else "python"."""
    arr = _native("\n".join(lines), width, integer)
    if arr is not None:
        return arr, "native"
    conv = int if integer else float
    return np.array([conv(s) for s in python_fields(lines, width)], np.int64 if integer else np.float64), "python"
