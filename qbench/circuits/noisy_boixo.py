"""Random circuits by Boixo et al.'s rules v2 (:mod:`boixo`) under
circuit-level depolarizing noise, run exactly on a density matrix
(``--backend density --noise <spec>``).

Each program is :mod:`boixo`'s text on the configuration's ``qubits``
qubits of its ``lattice``, drawn from the program's seed; ``noise`` is the
program's ``--noise`` spec. The state the harness compares is the program's
vectorized rho: ``num_qubits`` = 2 * ``qubits`` qubits, the row index in
the top ``qubits`` bits, as the program stores it.

The gate list (:func:`gates`) is the benchmark's own copy of the plain
reference (``qbench/reference/density.py``) in the form the state-vector
reference ``qbench.reference.simulate`` takes: a gate of the text on rows
T, with its elaborated U and CX and the channels after each, as one dense
gate on (T, T + n), the product of their superoperators (U as U (x)
conj(U), a channel as sum_i K_i (x) conj(K_i)): 4 x 4 for a single-qubit
gate, 16 x 16 for a cz. One pass over vec(rho) for each gate of the text.
The shots are drawn from rho's diagonal (:func:`probs`).
"""

from __future__ import annotations

import math

import numpy as np

from qbench.circuits import boixo
from qbench.reference import density as ref

draw = boixo.draw


def u_matrix(theta: float, phi: float, lam: float) -> np.ndarray:
    """OpenQASM 2.0's U(theta, phi, lambda) (arXiv:1707.03429, eq. 2)."""
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array([[c, -np.exp(1j * lam) * s],
                     [np.exp(1j * phi) * s, np.exp(1j * (phi + lam)) * c]],
                    dtype=np.complex128)


#: qelib1.inc's gates of the circuits as the U they elaborate to
U = {"h": u_matrix(math.pi / 2, 0, math.pi), "t": u_matrix(0, 0, math.pi / 4),
     "rx": u_matrix(math.pi / 2, -math.pi / 2, math.pi / 2),
     "ry": u_matrix(math.pi / 2, 0, 0)}
CX = np.eye(4, dtype=np.complex128)[[0, 1, 3, 2]]


def _circuit(cfg: dict) -> dict:
    return {**cfg, "num_qubits": cfg["qubits"]}


def text(cfg: dict, p: dict) -> str:
    """The program as OpenQASM 2.0: :func:`boixo.text` on ``qubits``."""
    return boixo.text(_circuit(cfg), p)


def _by_gate(cfg: dict, p: dict) -> list:
    """Each gate of the text beside its qubits, as the U and CX that
    qelib1.inc expands it into (cz a,b is h b; cx a,b; h b):
    ``[(qubits, [(u, targets)])]``."""
    out = []
    for ops in boixo.moments(cfg, p):
        for g, *qs in ops:
            if g == "cz":
                a, b = qs
                out.append(((a, b), [(U["h"], (b,)), (CX, (a, b)), (U["h"], (b,))]))
            else:
                out.append(((qs[0],), [(U[g], (qs[0],))]))
    return out


def elaborated(cfg: dict, p: dict) -> list[tuple[np.ndarray, tuple[int, ...]]]:
    """The program's gates as U and CX, ``[(u, targets)]``."""
    return [op for _, ops in _by_gate(cfg, p) for op in ops]


def superoperator(kraus) -> np.ndarray:
    """sum_i K_i (x) conj(K_i): the channel on vec(rho), the row targets
    the high bits of its index."""
    return sum(np.kron(k, np.conj(k)) for k in kraus)


def _embed(k: np.ndarray, targets: tuple, support: tuple) -> np.ndarray:
    """The operator ``k`` on ``targets`` as a matrix on ``support`` (its
    first qubit the most significant bit, as of ``k``'s targets)."""
    m = len(support)
    pos = [m - 1 - support.index(t) for t in targets]  # bit of each target
    full = np.zeros((1 << m, 1 << m), dtype=np.complex128)
    for col in range(1 << m):
        sub = sum(((col >> b) & 1) << (len(pos) - 1 - j) for j, b in enumerate(pos))
        for out in range(1 << len(pos)):
            row = col
            for j, b in enumerate(pos):
                row = (row & ~(1 << b)) | (((out >> (len(pos) - 1 - j)) & 1) << b)
            full[row, col] += k[out, sub]
    return full


def gates(cfg: dict, p: dict) -> list:
    """vec(rho)'s gate list from |0...0>, for ``qbench.reference.simulate``
    on ``num_qubits`` qubits: one dense gate for each gate of the text, the
    product of the superoperators of its elaborated U and CX and of the
    channels after each, on its qubits T as rows and T + n as columns."""
    n = cfg["qubits"]
    noise = ref.parse_noise(cfg["noise"])
    out = []
    for support, ops in _by_gate(cfg, p):
        total = np.eye(1 << 2 * len(support), dtype=np.complex128)
        for kraus, targets in ref.noisy_ops(ops, noise):
            total = superoperator([_embed(k, targets, support) for k in kraus]) @ total
        total[np.abs(total) < 1e-15] = 0  # what cancels exactly is left out
        out.append((total, support + tuple(t + n for t in support), False))
    return out


def probs(cfg: dict, ref):
    """The distribution the shots are drawn from: the real part of rho's
    diagonal, entries x * (2^q + 1) of vec(rho) for q = ``qubits``, the
    row index in the top q bits."""
    d = 1 << cfg["qubits"]
    return ref.view(d, d).diagonal().real
