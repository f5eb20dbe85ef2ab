"""Reduced density matrices and entanglement entropies of pure states.

rho_A = Tr_B |psi><psi| for a qubit subset A: view the state with each
qubit of A as an axis of its own, bring those axes to the front, read the
result as a (2^k, 2^(n-k)) matrix X and form rho_A = X X^dag with
``torch.matmul`` (the JAX package's product is a plain ``jnp.matmul`` too;
its SWAP network before it only exists because a rank-n transpose breaks the
TPU layout). The columns are taken in pieces of at most 2^_PIECE amplitudes,
so the permuted copy stays small beside a large state. The eigenvalues for
the von Neumann entropy are computed on the host in float64 (k <= 12
enforced).
"""

from __future__ import annotations

import numpy as np
import torch

from .apply import target_view

#: log2 of the amplitudes permuted and multiplied at a time
_PIECE = 26


def reduced_density_matrix(state: torch.Tensor, n: int, subset) -> np.ndarray:
    """Host-side complex (2^k, 2^k) rho_A for qubit subset A (the given
    order defines the row/column bit order; qubit subset[0] = MSB)."""
    subset = tuple(int(q) for q in subset)
    if len(set(subset)) != len(subset):
        raise ValueError("subset has duplicate qubits")
    if any(q < 0 or q >= n for q in subset):
        raise ValueError(f"subset out of range for n={n}: {subset}")
    if len(subset) > 12:
        raise ValueError("rho_A materializes 4^k entries; k > 12 refused")
    k = len(subset)
    srt = tuple(sorted(subset))
    dims, axes = target_view(n, srt)
    front = [axes[srt.index(q)] for q in subset]
    rest = [a for a in range(len(dims)) if a not in axes]
    view = state.view(dims).permute(front + rest)
    rho = torch.zeros(1 << k, 1 << k, dtype=torch.complex128, device=state.device)
    # cut the widest kept axis so that a piece holds at most 2^_PIECE entries
    pieces = [view]
    if rest and n > _PIECE:
        ax = max(range(k, len(dims)), key=lambda a: view.shape[a])
        step = max(1, view.shape[ax] >> (n - _PIECE))
        pieces = [view.narrow(ax, i, step) for i in range(0, view.shape[ax], step)]
    for piece in pieces:
        x = piece.reshape(1 << k, -1)
        rho += torch.matmul(x, x.conj().T)
    return rho.cpu().numpy()


def entanglement_entropy(state: torch.Tensor, n: int, subset,
                         base: float | None = None) -> float:
    """Von Neumann entropy S(rho_A) = -Tr(rho_A ln rho_A) in nats
    (``base=2`` for bits)."""
    rho = reduced_density_matrix(state, n, subset)
    w = np.linalg.eigvalsh(rho)
    w = w[w > 1e-12]
    s = float(-(w * np.log(w)).sum())
    return s / np.log(base) if base else s


def renyi2_entropy(state: torch.Tensor, n: int, subset,
                   base: float | None = None) -> float:
    """Renyi-2 entropy -ln Tr(rho_A^2)."""
    rho = reduced_density_matrix(state, n, subset)
    s = float(-np.log(max(np.real(np.trace(rho @ rho)), 1e-300)))
    return s / np.log(base) if base else s
