"""The plain reference: a dense state-vector simulator, gate by gate, in
plain PyTorch.

It takes the gate list that the benchmark's own generators emit beside each
program's text, never anything the program made, and imports nothing of the
program. Qubit q is bit n-1-q of a basis index. A 1-qubit gate is four
scaled adds over the two halves of the state's (2^q, 2, 2^(n-1-q)) view; a
diagonal multiplies each slice of its targets' view whose entry is not 1; a
dense gate on more targets sums the slices of that view by its nonzero
entries, block by block (a swap is then a copy).

``tf32=True`` is the control: every product is computed from inputs rounded
to TF32's 10 mantissa bits, as a TF32 tensor-core product takes them, with
float32 sums. It stands in for the program to show that the check fails a
precision one step below the float32 that the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

#: amplitudes a block of the 1-qubit update holds at once
_BLOCK = 1 << 26


def round_tf32_(x: torch.Tensor) -> torch.Tensor:
    """Round a complex64 or float32 tensor's float32 parts to TF32 (10
    mantissa bits, to nearest on the bit pattern), in place."""
    f = torch.view_as_real(x) if x.is_complex() else x
    b = f.view(torch.int32)
    b.add_(0x1000).bitwise_and_(-0x2000)
    return x


def _round_scalar(c: complex) -> complex:
    parts = np.array([c.real, c.imag], dtype=np.float32).view(np.uint32)
    parts = ((parts + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return complex(float(parts[0]), float(parts[1]))


def _apply_1q(state: torch.Tensor, u: np.ndarray, q: int, n: int, tf32: bool):
    u = [[complex(u[i, j]) for j in range(2)] for i in range(2)]
    if tf32:
        u = [[_round_scalar(c) for c in row] for row in u]
    hi, lo = 1 << q, 1 << (n - 1 - q)
    view = state.view(hi, 2, lo)
    # blocks along whichever axis is longer, so the temporary stays small
    step = max(1, _BLOCK // (2 * lo)) if hi >= lo else max(1, _BLOCK // (2 * hi))
    for s in range(0, hi if hi >= lo else lo, step):
        v = view[s:s + step] if hi >= lo else view[:, :, s:s + step]
        x0, x1 = v[:, 0], v[:, 1]
        if tf32:
            round_tf32_(x0)
            round_tf32_(x1)
        y0 = x0 * u[0][0]
        y0.add_(x1, alpha=u[0][1])
        x1.mul_(u[1][1]).add_(x0, alpha=u[1][0])
        x0.copy_(y0)


def _targets_view(state: torch.Tensor, targets, n: int):
    """The state as (2^a, 2, 2^b, 2, ...) around the sorted ``targets``, and
    for each entry of a gate's index the slice that it addresses."""
    k = len(targets)
    order = sorted(range(k), key=lambda i: targets[i])
    dims, prev = [], -1
    for q in (targets[i] for i in order):
        dims += [1 << (q - prev - 1), 2]
        prev = q
    dims.append(1 << (n - 1 - prev))

    def index(entry: int) -> tuple:
        idx = [slice(None)] * len(dims)
        for j, i in enumerate(order):
            idx[2 * j + 1] = (entry >> (k - 1 - i)) & 1
        return tuple(idx)

    return state.view(dims), index


def _apply_dense(state: torch.Tensor, u: np.ndarray, targets, n: int, tf32: bool):
    view, index = _targets_view(state, targets, n)
    d = 1 << len(targets)
    u = [[complex(u[i, j]) for j in range(d)] for i in range(d)]
    if tf32:
        u = [[_round_scalar(c) for c in row] for row in u]
    ax = max(range(0, view.dim(), 2), key=lambda a: view.shape[a])
    size = view.shape[ax]
    step = max(1, _BLOCK * size // state.numel())
    for s in range(0, size, step):
        v = view.narrow(ax, s, min(step, size - s))
        xs = [v[index(e)] for e in range(d)]
        if tf32:
            for x in xs:
                round_tf32_(x)
        ys = []
        for row in u:
            y = None
            for x, c in zip(xs, row):
                if c == 0:
                    continue
                if y is None:
                    y = x * c
                else:
                    y.add_(x, alpha=c)
            ys.append(torch.zeros_like(xs[0]) if y is None else y)
        for x, y in zip(xs, ys):
            x.copy_(y)


def _apply_diag(state: torch.Tensor, d: np.ndarray, targets, n: int, tf32: bool):
    view, index = _targets_view(state, targets, n)
    for entry in range(1 << len(targets)):
        c = complex(d[entry])
        if c == 1:
            continue
        if tf32:
            c = _round_scalar(c)
        part = view[index(entry)]
        if tf32:
            round_tf32_(part)
        part.mul_(c)


def simulate(n: int, gates, device, tf32: bool = False) -> torch.Tensor:
    """The final complex64 state of ``gates`` applied to |0...0>."""
    state = torch.zeros(1 << n, dtype=torch.complex64, device=device)
    state[0] = 1
    for u, targets, diag in gates:
        u = np.asarray(u)
        if diag:
            _apply_diag(state, u, tuple(targets), n, tf32)
        elif len(targets) == 1:
            _apply_1q(state, u, targets[0], n, tf32)
        else:
            _apply_dense(state, u, tuple(targets), n, tf32)
    return state
