"""The two kernels of the HBM bandwidth probe (``csrc/probe.cu``).

They are the simplest passes over a state with one access pattern each;
their rates are the ceilings that the engine's kernels are read against
(:mod:`qubism_torch.experiments.bw_probe` runs them).

* :func:`stream` -- a streaming pass in one of the :data:`MODES`: ``copy``
  into a second buffer, ``phase`` (times :data:`PHASE`, in place or into a
  second buffer), ``read`` (the sum of every real and imaginary part) and
  ``write`` (re = v, im = v / 2, with v = the real part of amplitude 0).
* :func:`pair` -- one qubit q: y0 = a x0 + b x1, y1 = (c x0 + d x1) p for
  each pair (x0, x1) at stride 2^(n-1-q), where p = ``row[b] * lane[c]``
  with ``b, c = divmod(offset in the tail, C)``, C = min(cols, tail); a
  missing row table reads 1 and a missing lane table reads ``phase``.

As in :mod:`.kernels`, each has a wrapper that launches the hand-written
kernel for a CUDA tensor (or raises) and runs the plain version
(``*_plain``, torch ops) for a CPU tensor, and a launch counter in
:data:`launches`, kept apart from ``kernels.launches``. A wrapper takes
``(state, operands..., n)`` and returns what it wrote (``read``: a
one-element float32 tensor holding the sum).

:func:`bound` gives the least time the card can take for a pass from its
bytes and operations, against the published peaks of one H100 SXM.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels
from .kernels import _check_state, _host, _ptr

#: kernel launches per wrapper since the last :func:`reset_launches`
launches = {"probe_stream": 0, "probe_pair": 0}

MODES = ("copy", "phase", "read", "write")
#: the probes' unit phase, C1 + i C2 (experiments/bw_probe.py:42)
PHASE = complex(np.float32(0.9238795), np.float32(0.3826834))
#: (threads per block, 16-byte vectors per thread and step)
DEFAULT_GEOMETRY = (256, 4)
#: the most blocks a pass launches (csrc/common.cuh: grid_for), and so the
#: read probe's partial sums
_MAX_BLOCKS = 1 << 16
_PAIR_MAX_THREADS = 512
_STREAM_MAX_THREADS = 1024

#: published peaks of one NVIDIA H100 SXM (data sheet, 700 W): HBM3 bytes/s
#: and float32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12


def reset_launches():
    for k in launches:
        launches[k] = 0


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the float32 operations over the peak rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stream_cost(mode: str, n: int) -> tuple[int, int]:
    """(bytes moved, flops) of one stream pass over 2^n amplitudes."""
    amps = 1 << n
    nbytes = {"copy": 16, "phase": 16, "read": 8, "write": 8}[mode] * amps
    flops = {"copy": 0, "phase": 6 * amps, "read": 2 * amps, "write": 0}[mode]
    return nbytes, flops


def pair_cost(n: int, row=None, lane=None) -> tuple[int, int]:
    """(bytes moved, flops) of one pair pass: every amplitude read and
    written once, the tables read once; per pair 4 complex multiply-adds,
    and the phase: one complex product (two with both tables)."""
    amps = 1 << n
    tables = sum(t.numel() * 8 for t in (row, lane) if t is not None)
    per_pair = 4 * 8 + 6 * (2 if row is not None and lane is not None else 1)
    return 16 * amps + tables, per_pair * amps // 2


def _check_geometry(geometry, max_threads: int):
    threads, vec = geometry
    if not (32 <= threads <= max_threads and threads % 32 == 0 and vec in (1, 2, 4)):
        raise ValueError(f"geometry {geometry}: threads a multiple of 32 up to "
                         f"{max_threads}, vec 1, 2 or 4")


def _check_out(out, state, mode=None):
    if out is None:
        return
    if out.dtype != state.dtype or out.shape != state.shape or not out.is_contiguous() \
            or out.device != state.device:
        raise ValueError(f"out must match the state: {state.dtype} {tuple(state.shape)} "
                         f"on {state.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    if mode == "copy" and out.data_ptr() == state.data_ptr():
        raise ValueError("copy: out must be a second buffer (a copy in place moves nothing)")


# ---------------------------------------------------------------------------
# the stream probe
# ---------------------------------------------------------------------------


def stream_plain(state: torch.Tensor, mode: str, n: int, out=None) -> torch.Tensor:
    """The stream pass in torch ops (see :func:`stream`)."""
    if mode == "copy":
        return out.copy_(state)
    if mode == "phase":
        return torch.mul(state, PHASE, out=state if out is None else out)
    if mode == "read":
        return torch.view_as_real(state).sum(dtype=torch.float64).to(torch.float32).reshape(1)
    if mode == "write":
        target = state if out is None else out
        seed = torch.view_as_real(state)[0, 0].clone()
        dst = torch.view_as_real(target)
        dst[:, 0].fill_(seed)
        dst[:, 1].fill_(seed * 0.5)
        return target
    raise ValueError(f"stream mode {mode!r}: one of {MODES}")


def stream(state: torch.Tensor, mode: str, n: int, out=None, *,
           geometry=DEFAULT_GEOMETRY) -> torch.Tensor:
    """One streaming pass over the 2^n-amplitude ``state``.

    ``copy`` writes ``out`` (required, a second buffer); ``phase`` and
    ``write`` write ``out`` or, without it, the state in place; ``read``
    returns the sum of every real and imaginary part as a one-element
    float32 tensor."""
    if mode not in MODES:
        raise ValueError(f"stream mode {mode!r}: one of {MODES}")
    if mode == "copy" and out is None:
        raise ValueError("copy: give out, a second buffer")
    if n < 1:
        raise ValueError("stream: n >= 1")
    _check_state(state, n)
    _check_out(out, state, mode)
    _check_geometry(geometry, _STREAM_MAX_THREADS)
    if state.device.type == "cpu":
        return stream_plain(state, mode, n, out)
    threads, vec = geometry
    dst = state if out is None else out
    null = ctypes.c_void_p(None)
    if mode == "read":
        partial = torch.empty(_MAX_BLOCKS, dtype=torch.float32, device=state.device)
        total = torch.empty(1, dtype=torch.float32, device=state.device)
        kernels._launch(state, "probe_stream", lambda lib, d, s: lib.qk_probe_stream(
            2, _ptr(state), null, n, null, null, _ptr(partial), partial.numel(), _ptr(total),
            threads, vec, d, s), counts=launches)
        return total
    if mode == "write":
        # the seed leaves the state before any block overwrites amplitude 0
        seed = torch.view_as_real(state)[0, 0:1].clone()
        kernels._launch(state, "probe_stream", lambda lib, d, s: lib.qk_probe_stream(
            3, null, _ptr(dst), n, null, _ptr(seed), null, 0, null, threads, vec, d, s),
            counts=launches)
        return dst
    ph = np.array([PHASE], dtype=np.complex64)
    kernels._launch(state, "probe_stream", lambda lib, d, s: lib.qk_probe_stream(
        MODES.index(mode), _ptr(state), _ptr(dst), n, _host(ph), null, null, 0, null,
        threads, vec, d, s), counts=launches)
    return dst


# ---------------------------------------------------------------------------
# the pair probe
# ---------------------------------------------------------------------------


def _pair_operands(coef, phase):
    """a, b, c, d, pc as complex64 (the values the kernel computes with)."""
    cf = np.asarray(coef, dtype=np.complex64).reshape(2, 2)
    return np.array([cf[0, 0], cf[0, 1], cf[1, 0], cf[1, 1], phase], dtype=np.complex64)


def _pair_tables(state, n: int, q: int, row, lane, cols: int):
    """C = min(cols, tail) as log2, after checking the tables' lengths."""
    if not 0 <= q < n:
        raise ValueError(f"pair: qubit {q} outside 0..{n - 1}")
    if cols < 1 or cols & (cols - 1):
        raise ValueError(f"pair: cols {cols} is not a power of two")
    tail = 1 << (n - 1 - q)
    C = min(cols, tail)
    for name, t, size in (("row", row, tail // C), ("lane", lane, C)):
        if t is None:
            continue
        if t.dtype != torch.complex64 or t.shape != (size,) or not t.is_contiguous() \
                or t.device != state.device:
            raise ValueError(f"pair: {name} table must be a contiguous complex64 ({size},) "
                             f"tensor on {state.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    return C.bit_length() - 1


def pair_plain(state: torch.Tensor, q: int, coef, n: int, *, phase=1, row=None, lane=None,
               cols=2048, out=None) -> torch.Tensor:
    """The pair pass in torch ops (see :func:`pair`)."""
    cbits = _pair_tables(state, n, q, row, lane, cols)
    a, b, c, d, pc = (complex(v) for v in _pair_operands(coef, phase))
    tail = 1 << (n - 1 - q)
    x = state.view(-1, 2, tail)
    y0 = x[:, 0] * a
    y0 += x[:, 1] * b
    y1 = x[:, 0] * c
    y1 += x[:, 1] * d
    p = pc if lane is None else lane.view(1, -1)
    if row is not None:
        p = row.view(-1, 1) * p
    y1.view(-1, tail >> cbits, 1 << cbits).mul_(p)  # p broadcast over (b, c)
    dst = (state if out is None else out).view(-1, 2, tail)
    dst[:, 0] = y0
    dst[:, 1] = y1
    return state if out is None else out


def pair(state: torch.Tensor, q: int, coef, n: int, *, phase=1, row=None, lane=None, cols=2048,
         out=None, geometry=DEFAULT_GEOMETRY) -> torch.Tensor:
    """The 2x2 ``coef`` [[a, b], [c, d]] on qubit ``q`` with the phase p on
    the |1> branch, in place or into ``out``. ``row`` (tail / C,) and
    ``lane`` (C,) are optional complex64 tables on the state's device."""
    _check_state(state, n)
    _check_out(out, state)
    _check_geometry(geometry, _PAIR_MAX_THREADS)
    cbits = _pair_tables(state, n, q, row, lane, cols)
    if state.device.type == "cpu":
        return pair_plain(state, q, coef, n, phase=phase, row=row, lane=lane, cols=cols, out=out)
    threads, vec = geometry
    dst = state if out is None else out
    ops = _pair_operands(coef, phase)
    null = ctypes.c_void_p(None)
    kernels._launch(state, "probe_pair", lambda lib, d, s: lib.qk_probe_pair(
        _ptr(state), _ptr(dst), n, q, _host(ops), null if row is None else _ptr(row),
        null if lane is None else _ptr(lane), cbits, threads, vec, d, s), counts=launches)
    return dst
