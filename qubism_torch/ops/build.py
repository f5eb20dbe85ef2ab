"""Build and load the CUDA kernels of ``qubism_torch/csrc``.

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``: one ``nvcc -c`` per
source, all started together, then one link. Nothing here runs at import:
:func:`library` builds on first use, into
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
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def _run_all(cmds) -> str:
    """Run the commands at once; raise on the first that fails. Returns
    their output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    logs, failed = [], None
    for cmd, proc in procs:
        text = proc.communicate()[0]
        logs.append(text)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, text)
    if failed:
        cmd, rc, text = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    return "".join(logs)


def build() -> Path:
    """Compile the sources unless a library built from them exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as work:
        objs = [os.path.join(work, src.stem + ".o") for src in SOURCES]
        log = _run_all([[_nvcc(), *FLAGS, "-c", "-o", obj, str(src)]
                        for src, obj in zip(SOURCES, objs)])
        tmp = os.path.join(work, out.name)
        log += _run_all([[_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                          "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    build_log = log
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
    lib.qk_gate_dev.argtypes = [p, i64, i32, p, p, i32, p]
    lib.qk_layer1q_dev.argtypes = [p, i64, i32, p, p, i32, p]
    lib.qk_lane.argtypes = [p, i64, p, i32, p]
    lib.qk_diag.argtypes = [p, i64, p, i64, p, i32, i32, i32, p, i32, p]
    lib.qk_diag1.argtypes = [p, i64, i32, p, p, i32, p]
    lib.qk_stage.argtypes = [p, i64, i32, p, p, p, i32, i32, p]
    lib.qk_butterfly.argtypes = [p, i32, i64, p, i32, p]
    lib.qk_probe_stream.argtypes = [i32, p, p, i64, p, p, i32, i32, i32, p]
    lib.qk_probe_read_occupancy.argtypes = [i32, i32, i32, p]
    lib.qk_probe_copy.argtypes = [p, p, i64, i32, i32, i32, i64, i32, i32, i32, p]
    lib.qk_probe_read.argtypes = [p, i64, i32, i32, i32, i64, i32, p, i64, p, p, i32, p]
    lib.qk_probe_pair.argtypes = [p, p, i64, i32, p, p, p, i32, i32, i32, i32, p]
    for fn in (lib.qk_gate, lib.qk_layer1q, lib.qk_gate_dev, lib.qk_layer1q_dev,
               lib.qk_lane, lib.qk_diag, lib.qk_diag1,
               lib.qk_stage, lib.qk_butterfly, lib.qk_probe_stream,
               lib.qk_probe_read_occupancy, lib.qk_probe_copy, lib.qk_probe_read,
               lib.qk_probe_pair):
        fn.restype = ctypes.c_int
    lib.qk_error_string.argtypes = [ctypes.c_int]
    lib.qk_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
