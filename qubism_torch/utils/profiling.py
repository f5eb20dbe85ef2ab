"""Timing and tracing: the CLI's ``--verbose`` per-statement timing,
``trace`` (a ``torch.profiler`` trace for Perfetto or chrome://tracing),
``timed`` (seconds per call) and ``hbm_fraction`` (a pass count against
the card's memory rate), and ``count_ops``."""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..config import config
from ..ops.probes import PEAK_BYTES_PER_S

#: set by the CLI's --verbose flag: per-statement timing to stderr
VERBOSE = False


def vlog(msg: str):
    if VERBOSE:
        print(f"[qubism] {msg}", file=sys.stderr, flush=True)


@contextlib.contextmanager
def vtimed(label: str):
    """Time a block when VERBOSE. Kernels run asynchronously on the card,
    so the block's end waits for the device (torch.cuda.synchronize)."""
    if not VERBOSE:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        vlog(f"{label}: {(time.perf_counter() - t0) * 1e3:.1f} ms")


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
                 peak_bw: float = PEAK_BYTES_PER_S) -> float:
    """Share of the memory rate ``peak_bw`` (bytes/s; default one H100
    SXM's published HBM3 rate) that ``passes`` full passes over an n-qubit
    complex64 state in ``seconds`` reach: a pass reads and writes the
    state once, 16 bytes an amplitude."""
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
