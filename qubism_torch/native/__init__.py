"""The native (C++) OpenQASM scanner of the lexer, loaded with ``ctypes``.

Machine-generated circuit files (brickwork, QFT and adder benchmarks at 30
qubits) run to hundreds of kilobytes, where the Python lexer's loop over
characters is most of the parse. ``qasm_lexer.cpp`` finds the token
boundaries, kinds and source positions in one pass; the tokens themselves
are built here from the source spans, so they equal the Python lexer's.

:func:`ensure_built` compiles the source with ``g++ -O2 -shared -fPIC`` on
first use, into ``qubism_torch/_build/native-<hash of the source, compiler
and flags>/libqasm_lexer.so`` (listed in ``.gitignore``), and loads it.
Where that fails (no compiler), it returns None, :data:`build_error` holds
the reason and ``qasm/lexer.py`` keeps to its Python route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "qasm_lexer.cpp"
#: the host compiler and its flags
CXX = "g++"
FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
#: why the library could not be built or loaded; None until a build fails
build_error: str | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX, *FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return _PKG / "_build" / f"native-{h.hexdigest()[:16]}" / "libqasm_lexer.so"


def _build(out: Path) -> None:
    """Compile into a temporary file beside ``out``, then rename it: a
    process building at the same time never loads half a library."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as work:
        tmp = os.path.join(work, out.name)
        proc = subprocess.run([CXX, *FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed ({proc.returncode}): {proc.stderr.strip()}")
        os.replace(tmp, out)


def ensure_built():
    """Build (if needed) and load the scanner. Returns the ``ctypes``
    library, or None when it cannot be built or loaded (``build_error``
    says why; a failed build is not tried again in this process)."""
    global _lib, build_error
    if _lib is not None or build_error is not None:
        return _lib
    with _lock:
        if _lib is not None or build_error is not None:
            return _lib
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_error = f"{type(e).__name__}: {e}"
            return None
        p, i64 = ctypes.c_void_p, ctypes.c_long
        lib.qasm_lex.restype = i64
        lib.qasm_lex.argtypes = [ctypes.c_char_p, i64, p, p, p, p, p, p, i64,
                                 ctypes.POINTER(i64)]
        _lib = lib
    return _lib


def native_tokenize(text: str, file: str = ""):
    """Tokenize with the native scanner: the list of ``Tok`` that
    ``qasm.lexer._tokenize_py`` gives, or None when the scanner is not
    available or rejects the input (the Python lexer then raises the
    diagnostic)."""
    lib = ensure_built()
    if lib is None:
        return None
    from ..qasm.ast import SourcePos
    from ..qasm.lexer import RESERVED, Tok

    data = text.encode("utf-8")
    cap = max(16, len(data))  # a token takes at least one byte
    kinds = np.empty(cap, np.uint8)
    starts, lengths, lines, cols = (np.empty(cap, np.int64) for _ in range(4))
    values = np.empty(cap, np.float64)
    err_pos = ctypes.c_long(0)
    count = lib.qasm_lex(data, len(data), kinds.ctypes.data, starts.ctypes.data,
                         lengths.ctypes.data, values.ctypes.data, lines.ctypes.data,
                         cols.ctypes.data, cap, ctypes.byref(err_pos))
    if count < 0:
        return None
    starts, lengths, cols = starts[:count], lengths[:count], cols[:count]
    if len(data) != len(text):
        # the scanner counts bytes, the lexer characters: take the UTF-8
        # continuation bytes before each offset off spans and columns
        cont = (np.frombuffer(data, np.uint8) & 0xC0) == 0x80
        before = np.concatenate(([0], np.cumsum(cont)))
        line_start = starts - (cols - 1)
        cols = cols - (before[starts] - before[line_start])
        lengths = lengths - (before[starts + lengths] - before[starts])
        starts = starts - before[starts]

    toks = []
    append = toks.append
    for k, s, ln, line, col in zip(kinds[:count].tolist(), starts.tolist(), lengths.tolist(),
                                   lines[:count].tolist(), cols.tolist()):
        pos = SourcePos(file, line, col)
        span = text[s:s + ln]
        if k == 0:
            append(Tok("kw" if span in RESERVED else "ident", span, pos))
        elif k == 1:
            # numbers from the source span, as the Python lexer reads them:
            # a C double loses integers above 2^53
            append(Tok("nat", int(span), pos))
        elif k == 2:
            append(Tok("real", float(span), pos))
        elif k == 3:
            append(Tok("sym", span, pos))
        elif k == 4:
            append(Tok("str", span, pos))
        else:
            append(Tok("dump", ":dump", pos))
    # the end of the input, after any trailing whitespace, as the Python
    # lexer reports it
    last_nl = text.rfind("\n")
    append(Tok("eof", None, SourcePos(file, text.count("\n") + 1, len(text) - last_nl)))
    return toks
