"""Shot sampling from a final state (non-destructive).

An inverse CDF with ``searchsorted(side="right")`` semantics, as the JAX
package's ``_sample_parts``: shot u in [0, total) picks the first index whose
inclusive prefix mass exceeds u. It runs in two levels so no state-sized
prefix sum is built: per-row masses (rows of 2^11 amplitudes) accumulated in
float64, a float64 CDF over the rows to pick each shot's row, then the
float64 prefix sum of that one row. A flat float32 cumsum over 2^30 terms
would lose the small masses.
"""

from __future__ import annotations

import numpy as np
import torch

from .measure import draw

#: leaf row width of the two-level search
_LEAF_BITS = 11
#: amplitudes per chunk when summing row masses (bounds the float temps)
_CHUNK = 1 << 24


def _row_masses(state: torch.Tensor, width: int) -> torch.Tensor:
    """float64 probability mass of each row of ``width`` amplitudes."""
    rows = state.view(-1, width)
    step = max(1, _CHUNK // width)
    out = []
    for r in range(0, rows.shape[0], step):
        blk = torch.view_as_real(rows[r:r + step]).double()
        out.append(blk.square().sum(dim=(1, 2)))
    return torch.cat(out)


def row_cdf(state: torch.Tensor, n: int) -> torch.Tensor:
    """The float64 inclusive prefix sum of the row masses (rows of
    2^min(n, 11) amplitudes); its last entry is the state's total mass."""
    return torch.cumsum(_row_masses(state, 1 << min(n, _LEAF_BITS)), 0)


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
    u = torch.from_numpy(draw(gen, shots, uniforms)).to(state.device)
    cdf = row_cdf(state, n)
    return search(state, n, u * cdf[-1], cdf).cpu().numpy()


def sample_counts(state: torch.Tensor, n: int, shots: int,
                  gen: torch.Generator | None = None) -> dict[str, int]:
    """Sample and histogram: returns {big-endian bitstring: count}."""
    idx = sample_indices(state, n, shots, gen)
    vals, counts = np.unique(idx, return_counts=True)
    return {format(int(v), f"0{n}b"): int(c) for v, c in zip(vals, counts)}
