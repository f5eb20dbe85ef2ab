"""Shot sampling from a final state (non-destructive).

An inverse CDF with ``searchsorted(side="right")`` semantics, as the JAX
package's ``_sample_parts``: shot u in [0, total) picks the first index whose
inclusive prefix mass exceeds u. It runs in two levels so no state-sized
prefix sum is built: per-row masses (rows of 2^11 amplitudes, one read of
the state: each row's squared float32 2-norm), a float64 CDF over the rows
to pick each shot's row, then the float64 prefix sum of that one row. A flat
float32 cumsum over 2^30 terms would lose the small masses.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling
from .apply import to_device, to_host
from .measure import draw

#: leaf row width of the two-level search
_LEAF_BITS = 11


def row_cdf(state: torch.Tensor, n: int) -> torch.Tensor:
    """The float64 inclusive prefix sum of the row masses (rows of
    2^min(n, 11) amplitudes); its last entry is the state's total mass."""
    rows = state.view(-1, 1 << min(n, _LEAF_BITS))
    return torch.cumsum(torch.linalg.vector_norm(rows, dim=1).double().square_(), 0)


def search(state: torch.Tensor, n: int, target: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
    """For each float64 mass ``target`` in [0, total), the first index whose
    inclusive prefix mass exceeds it (``cdf`` from :func:`row_cdf`), int64 on
    the state's device."""
    width = 1 << min(n, _LEAF_BITS)
    row = torch.searchsorted(cdf, target, right=True).clamp_(max=cdf.numel() - 1)
    resid = target - torch.where(row > 0, cdf[(row - 1).clamp_(min=0)],
                                 torch.zeros_like(target))
    leaf = torch.view_as_real(state.view(-1, width)[row]).double().square().sum(-1)
    leaf_cdf = torch.cumsum(leaf, 1)
    col = torch.searchsorted(leaf_cdf, resid[:, None], right=True)[:, 0]
    col.clamp_(max=width - 1)
    return row.to(torch.int64) * width + col.to(torch.int64)


def sample_indices(state: torch.Tensor, n: int, shots: int,
                   gen: torch.Generator | None = None, uniforms=None) -> np.ndarray:
    """Sample ``shots`` basis-state indices; (shots,) int64 on the host.
    ``uniforms`` (shots floats in [0, 1)) replaces the generator's draws."""
    u = to_device(draw(gen, shots, uniforms), state.device)
    cdf = row_cdf(state, n)
    return to_host(search(state, n, u * cdf[-1], cdf))


def sample_into(state: torch.Tensor, n: int, u: torch.Tensor, out: torch.Tensor,
                alive: torch.Tensor | None = None) -> torch.Tensor:
    """One Born sample of ``state`` with the device uniform ``u`` (a (1,)
    float64 tensor in [0, 1)), written into ``out`` (a (1,) int64 device
    tensor, e.g. one entry of a trajectory batch's outcome vector) with no
    host read: the counterpart of the JAX package's ``_sample_parts`` /
    ``_sample_parts_big`` for one shot, in int64 so no index is split.
    ``alive`` (a 0-d bool tensor) False writes index 0: a state annihilated
    by a projection measures as all-zero bits."""
    cdf = row_cdf(state, n)
    idx = search(state, n, u.reshape(1) * cdf[-1:], cdf)
    if alive is not None:
        idx = torch.where(alive, idx, torch.zeros_like(idx))
    return out.copy_(idx)


def sample_counts(state: torch.Tensor, n: int, shots: int,
                  gen: torch.Generator | None = None) -> dict[str, int]:
    """Sample and histogram: returns {big-endian bitstring: count}."""
    with profiling.span("qubism.sample"):
        idx = sample_indices(state, n, shots, gen)
        vals, counts = np.unique(idx, return_counts=True)
        return {format(int(v), f"0{n}b"): int(c) for v, c in zip(vals, counts)}
