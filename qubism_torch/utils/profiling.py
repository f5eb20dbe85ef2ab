"""Timing and tracing: the port's spans and counters (:func:`span`,
:func:`count`, :data:`counters`) and the CLI's ``--verbose`` line built from
them, ``trace`` (a ``torch.profiler`` trace for Perfetto or
chrome://tracing), ``timed`` (seconds per call) and ``hbm_fraction`` (a pass
count against the card's memory rate), and ``count_ops``.

A span marks where the port's host works: ``qubism.program`` (one file),
``qubism.parse``, ``qubism.lex``, ``qubism.interp``, ``qubism.flush``,
``qubism.fuse``, ``qubism.plan``, ``qubism.sync`` (a copy between host and
device) and ``qubism.sample``; on the exact density backend
``qubism.density`` (a run) around ``qubism.density.unitary`` (a gate's row
and column passes, or a run of gates and their channels composed into one
superoperator and applied in one pass), ``qubism.density.channel`` and
``qubism.density.readout``; in the kernel adjoint engine
(``models/adjoint_engine.py``) ``qubism.adjoint`` (one value+grad call)
around ``qubism.adjoint.sweep`` (a unit's operands built and its kernels
launched, forward or reverse), ``qubism.adjoint.head`` (E and lam = H phi)
and ``qubism.adjoint.contract`` (a unit's gradient walks); each nested in
its caller. Under a running ``torch.profiler`` a span is a
``record_function`` on the profiler's clock, the clock of the device's
work in the same trace; under ``--verbose`` its host time is summed by
name; otherwise it is a shared no-op context.
This module imports nothing of the package but its configuration, so that
any module of it can import this one.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch
import torch.autograd.profiler
from torch.autograd.profiler import record_function
from torch.utils._python_dispatch import TorchDispatchMode

from ..config import config

#: set by the CLI's --verbose flag: one stderr line a program with the host
#: ms of each span name and the counters (:func:`program`)
VERBOSE = False

#: events since the last ``ops.kernels.reset_launches()``: ``syncs`` (copies
#: across the host/device boundary, ``ops.apply.to_device`` / ``to_host``),
#: ``prims`` and ``fused_ops`` (what each interpreter flush hands to
#: ``ops.fusion.fuse_scheduled`` and gets back), ``sched_layered`` and
#: ``sched_greedy`` (QASM flushes and ``--compile`` segments whose layered or
#: greedy plan was kept) and ``diag_runs`` (the runs of prims made into one
#: diagonal in the layered plans kept), ``rho_unitary_passes``,
#: ``rho_channel_passes`` and ``rho_fused_passes`` (passes over a density
#: matrix, ``core.density``: a gate's rows or columns, a channel, a composed
#: run of gates and channels), ``rho_fused_prims`` (the gates of those runs)
#: and ``pair_walks`` (walks of a pair of states by
#: ``ops.measure.pauli_pair_sums``, one a flip mask of a reduction)
counters: dict[str, int] = {}

#: the counters the --verbose line always reports, and those it reports
#: where they rose in the program
_REPORTED = ("syncs", "prims", "fused_ops")
_REPORTED_IF_ANY = ("sched_greedy", "sched_layered", "diag_runs", "rho_unitary_passes",
                    "rho_channel_passes", "rho_fused_passes", "rho_fused_prims")

#: host seconds in each span name while VERBOSE, in the current program
span_s: dict[str, float] = {}

_OFF = contextlib.nullcontext()


def vlog(msg: str):
    if VERBOSE:
        print(f"[qubism] {msg}", file=sys.stderr, flush=True)


def profiler_on() -> bool:
    """Whether a torch profiler is recording: the flag torch keeps for fast
    checks from Python."""
    return torch.autograd.profiler._is_profiler_enabled


def span(name: str):
    """A context for the work of one span named ``name``: a
    ``record_function`` while a torch profiler records, timed on the host
    clock into :data:`span_s` when VERBOSE (never a synchronisation: the
    device's work is only enqueued), else a shared no-op context."""
    if VERBOSE:
        return _timed(name)
    if profiler_on():
        return record_function(name)
    return _OFF


@contextlib.contextmanager
def _timed(name: str):
    t0 = time.perf_counter()
    try:
        with record_function(name) if profiler_on() else _OFF:
            yield
    finally:
        span_s[name] = span_s.get(name, 0.0) + time.perf_counter() - t0


def count(name: str, k: int = 1):
    """Add ``k`` to the counter ``name``."""
    counters[name] = counters.get(name, 0) + k


@contextlib.contextmanager
def program():
    """The ``qubism.program`` span of one program. Under VERBOSE its end
    prints the --verbose line: the host ms of each span name in the program
    and how far each reported counter rose over it (the density passes
    where there were any)."""
    since = dict(counters)
    try:
        with span("qubism.program"):
            yield
    finally:
        if VERBOSE:
            spans = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in span_s.items())
            rose = {k: counters.get(k, 0) - since.get(k, 0)
                    for k in _REPORTED + _REPORTED_IF_ANY}
            counts = ", ".join(f"{k} {v}" for k, v in rose.items()
                               if k in _REPORTED or v)
            vlog(f"program: host ms {spans}; {counts}")
            span_s.clear()


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when ``config.device`` is a CUDA device) and write its trace
    into ``log_dir`` as ``trace-<pid>-<ns>.json``, a Chrome trace that
    Perfetto reads. Yields the profiler (``key_averages()`` etc.)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(config.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def timed(fn, *args, reps: int = 5, warmup: int = 1) -> float:
    """Seconds per call of ``fn(*args)``: ``warmup`` calls, then the mean
    of ``reps`` on the host clock. CUDA launches return before the work
    ends, so the device is synchronised before each reading of the clock."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / reps


def hbm_fraction(n_qubits: int, passes: int, seconds: float,
                 peak_bw: float | None = None) -> float:
    """Share of the memory rate ``peak_bw`` (bytes/s; default one H100
    SXM's published HBM3 rate, ``ops.probes.PEAK_BYTES_PER_S``) that
    ``passes`` full passes over an n-qubit complex64 state in ``seconds``
    reach: a pass reads and writes the state once, 16 bytes an amplitude."""
    if peak_bw is None:
        from ..ops.probes import PEAK_BYTES_PER_S as peak_bw
    bytes_per_pass = 2 * 8 * (1 << n_qubits)
    return passes * bytes_per_pass / seconds / peak_bw


class _OpCounter(TorchDispatchMode):
    """Counts the torch operators dispatched inside it, views excluded: on
    the card each is about one kernel launch (an indexed write may be two)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.count += 1
        return func(*args, **(kwargs or {}))


def count_ops(fn):
    """(fn(), the number of non-view torch operators it dispatched)."""
    with _OpCounter() as c:
        out = fn()
    return out, c.count
