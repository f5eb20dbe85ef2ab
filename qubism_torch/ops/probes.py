"""The kernels of the HBM bandwidth probe (``csrc/probe.cu``,
``csrc/probe_copy_read.cu``).

They are the simplest passes over a state with one access pattern each;
their rates are the ceilings that the engine's kernels are read against
(:mod:`qubism_torch.experiments.bw_probe` runs them).

* :func:`stream` -- a streaming pass in one of the :data:`MODES`: ``copy``
  into a second buffer, ``phase`` (times :data:`PHASE`, in place or into a
  second buffer), ``read`` (the sum of every real and imaginary part) and
  ``write`` (re = v, im = v / 2, with v = the real part of amplitude 0).
  Copy and read go to their own kernels (:func:`copy`, :func:`read`; the
  tiles each block takes are computed here, :func:`partition`); the read
  runs in one launch, and its sum is the same bit for bit from call to
  call. Phase and write go to ``qk_probe_stream``.
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
bytes and operations, against the published peaks of one H100 SXM (the
float32 rate, or for the lane kernel's three TF32 products the TF32 rate).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels
from .kernels import _check_state, _host, _ptr

#: kernel launches per wrapper since the last :func:`reset_launches`
launches = {"probe_stream": 0, "probe_copy": 0, "probe_read": 0, "probe_pair": 0}

MODES = ("copy", "phase", "read", "write")
#: the probes' unit phase, C1 + i C2 (experiments/bw_probe.py:42)
PHASE = complex(np.float32(0.9238795), np.float32(0.3826834))
#: (threads per block, 16-byte vectors per thread and step)
DEFAULT_GEOMETRY = (256, 4)
_PAIR_MAX_THREADS = 512
_STREAM_MAX_THREADS = 1024
#: the copy's grid is one block per tile up to this many blocks
COPY_MAX_BLOCKS = 1 << 30
#: the most KiB of tiles the copy keeps resident on an SM (fewer blocks an
#: SM where its own limits would allow more; 0: no cap). On an H100 the copy
#: reads fastest with 32-64 KiB in flight an SM (PERF.md, Findings)
COPY_INFLIGHT_KIB = 48

#: published peaks of one NVIDIA H100 SXM (data sheet, 700 W): HBM3 bytes/s,
#: float32 operations/s outside the tensor cores, and dense TF32
#: operations/s on them
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12


def reset_launches():
    for k in launches:
        launches[k] = 0


def bound(nbytes: float, flops: float, tf32x3: bool = False) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the float32 operations over the peak rate. ``tf32x3``:
    the operations run on the tensor cores as three TF32 products each (the
    lane kernel), so 3 x the operations over the TF32 peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (3 * flops / PEAK_TF32_FLOP_PER_S if tf32x3 else flops / PEAK_FP32_FLOP_PER_S) * 1e3
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
    if mode == "copy" and (out is state or out.data_ptr() == state.data_ptr()):
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
    if mode == "copy":
        return copy(state, n, out, geometry=geometry)
    _check_stream(state, n, out, geometry, mode)
    if mode == "read":
        return read(state, n, geometry=geometry)
    if state.device.type == "cpu":
        return stream_plain(state, mode, n, out)
    threads, vec = geometry
    dst = state if out is None else out
    null = ctypes.c_void_p(None)
    if mode == "write":
        # the seed leaves the state before any block overwrites amplitude 0
        seed = torch.view_as_real(state)[0, 0:1].clone()
        kernels._launch(state, "probe_stream", lambda lib, d, s: lib.qk_probe_stream(
            3, null, _ptr(dst), n, null, _ptr(seed), threads, vec, d, s), counts=launches)
        return dst
    ph = np.array([PHASE], dtype=np.complex64)
    kernels._launch(state, "probe_stream", lambda lib, d, s: lib.qk_probe_stream(
        1, _ptr(state), _ptr(dst), n, _host(ph), null, threads, vec, d, s), counts=launches)
    return dst


def partition(n: int, threads: int, vec: int, max_blocks: int) -> tuple[int, int, int]:
    """(blocks, per, extra): how the copy and read kernels share a state of
    2^n amplitudes. Its 2^n / 2 float4s are cut into tiles of ``threads *
    vec``; there are min(tiles, ``max_blocks``) blocks (at least 1), and
    block b takes ``per + (b < extra)`` tiles. The copy walks its tiles b,
    b + blocks, b + 2 blocks, ... (``max_blocks`` = ``COPY_MAX_BLOCKS``: one
    tile each below 2^30 tiles), the read the contiguous run from ``b * per
    + min(b, extra)`` (``max_blocks`` = :func:`read_slots`). The float4s
    past the last full tile are the last block's."""
    tiles = (1 << n) // 2 // (threads * vec)
    blocks = max(1, min(max_blocks, tiles))
    per, extra = divmod(tiles, blocks)
    return blocks, per, extra


#: (device, threads, vec) -> the read kernel's blocks resident on the card
_read_slots = {}
#: device -> (float32 partials, uint32 ticket counter): the read kernel's
#: scratch, kept between calls (the kernel leaves the counter at 0)
_read_scratch = {}


def read_slots(geometry, device: int) -> int:
    """How many blocks of the read kernel at ``geometry`` the card holds at
    once (qk_probe_read_occupancy: SMs x blocks resident per SM); the read's
    grid."""
    key = (device, *geometry)
    if key not in _read_slots:
        from . import build

        lib = build.library()
        out = (ctypes.c_int * 2)()
        rc = lib.qk_probe_read_occupancy(*geometry, device, out)
        if rc != 0:
            raise RuntimeError(f"probe read: occupancy query failed: "
                               f"{lib.qk_error_string(rc).decode()} ({rc})")
        if out[1] < 1:
            raise RuntimeError(f"probe read: no block of {geometry} fits on an SM")
        _read_slots[key] = out[0] * out[1]
    return _read_slots[key]


def _check_stream(state, n, out, geometry, mode):
    if n < 1:
        raise ValueError("stream: n >= 1")
    _check_state(state, n)
    _check_out(out, state, mode)
    _check_geometry(geometry, _STREAM_MAX_THREADS)


def copy(state: torch.Tensor, n: int, out: torch.Tensor, *,
         geometry=DEFAULT_GEOMETRY) -> torch.Tensor:
    """``out`` = the state, by the copy kernel (one block a tile, at most
    ``COPY_INFLIGHT_KIB`` of tiles resident on an SM); what
    ``stream(state, "copy", n, out)`` runs."""
    if out is None:
        raise ValueError("copy: give out, a second buffer")
    _check_stream(state, n, out, geometry, "copy")
    if state.device.type == "cpu":
        return stream_plain(state, "copy", n, out)
    blocks, per, extra = partition(n, *geometry, COPY_MAX_BLOCKS)
    kernels._launch(state, "probe_copy", lambda lib, d, s: lib.qk_probe_copy(
        _ptr(state), _ptr(out), n, *geometry, blocks, per, extra, COPY_INFLIGHT_KIB, d, s),
        counts=launches)
    return out


def read(state: torch.Tensor, n: int, *, geometry=DEFAULT_GEOMETRY) -> torch.Tensor:
    """The sum of every real and imaginary part, a one-element float32
    tensor, by the read kernel on a grid of :func:`read_slots` blocks; what
    ``stream(state, "read", n)`` runs."""
    _check_stream(state, n, None, geometry, "read")
    if state.device.type == "cpu":
        return stream_plain(state, "read", n)
    total = torch.empty(1, dtype=torch.float32, device=state.device)

    def call(lib, d, s):
        blocks, per, extra = partition(n, *geometry, read_slots(geometry, d))
        partial, counter = _read_scratch.get(d, (None, None))
        if partial is None or partial.numel() < blocks:
            partial = torch.empty(blocks, dtype=torch.float32, device=state.device)
            counter = torch.zeros(1, dtype=torch.int32, device=state.device)
            _read_scratch[d] = (partial, counter)
        return lib.qk_probe_read(_ptr(state), n, *geometry, blocks, per, extra, _ptr(partial),
                                 partial.numel(), _ptr(counter), _ptr(total), d, s)

    kernels._launch(state, "probe_read", call, counts=launches)
    return total


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
