"""Build and load the CUDA kernels of ``qubism_torch/csrc``.

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``. Nothing here runs at
import: :func:`library` builds on first use, into
``qubism_torch/_build/<hash of the sources and flags>/`` (listed in
``.gitignore``), and reuses a library already built from the same sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
#: what nvcc printed for the last build (ptxas register/shared-memory lines)
build_log: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in SOURCES + HEADERS:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return _PKG / "_build" / _digest() / "libqubism_kernels.so"


def build() -> Path:
    """Compile the sources unless a library built from them exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *FLAGS, "-o", tmp, *map(str, SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    build_log = res.stdout + res.stderr
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's signature set."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    # every entry ends in (device index, stream)
    lib.qk_gate.argtypes = [p, i64, i32, p, p, i32, p]
    lib.qk_layer1q.argtypes = [p, i64, i32, p, p, i32, p]
    lib.qk_lane.argtypes = [p, i64, p, i32, p]
    lib.qk_diag.argtypes = [p, i64, p, i64, p, i32, i32, p]
    for fn in (lib.qk_gate, lib.qk_layer1q, lib.qk_lane, lib.qk_diag):
        fn.restype = ctypes.c_int
    lib.qk_error_string.argtypes = [ctypes.c_int]
    lib.qk_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
