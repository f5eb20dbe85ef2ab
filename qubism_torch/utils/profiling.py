"""Verbose per-statement timing (the CLI's ``--verbose``)."""

from __future__ import annotations

import contextlib
import sys
import time

import torch

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
