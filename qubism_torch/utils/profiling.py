"""Verbose per-statement timing (the CLI's ``--verbose``)."""

from __future__ import annotations

import contextlib
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        vlog(f"{label}: {(time.perf_counter() - t0) * 1e3:.1f} ms")


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
