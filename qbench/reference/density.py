"""The plain reference of the noisy configurations: an n-qubit density
matrix as an explicit (2^n, 2^n) complex64 matrix, in plain PyTorch.

It imports nothing of the program. Qubit q is bit n-1-q of a row or column
index, and targets[0] the most significant bit of an operator's index. A
gate maps rho -> U rho U^dag and a channel rho -> sum_i K_i rho K_i^dag,
each by matrix products over the targets' axes of rho's rows and then of
its columns, in float32 with TF32 off. The channels are written from their
published Kraus forms (Nielsen and Chuang, section 8.3.4, and its
two-qubit form):

* ``depolarizing:p``: sqrt(1 - p) I and sqrt(p/3) X, Y, Z, so that each
  Pauli error has probability p/3;
* ``dep2:p``: sqrt(1 - p) I (x) I and sqrt(p/15) P (x) Q for each of the 15
  non-identity Pauli pairs.

Noise is circuit-level, as the program's ``--noise`` defines it: after each
gate that OpenQASM's U and CX elaborate (qelib1's gates expanded into
them), each channel of the spec in its order: a 1-qubit channel on each
qubit the gate touches, a 2-qubit one once after each 2-qubit gate on its
pair (:func:`noisy_ops`).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

_I = np.eye(2, dtype=np.complex128)
_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
_Z = np.array([[1, 0], [0, -1]], dtype=np.complex128)
PAULIS = (_I, _X, _Y, _Z)


def depolarizing(p: float) -> list[np.ndarray]:
    """The 1-qubit depolarizing channel's Kraus operators."""
    return [math.sqrt(1 - p) * _I] + [math.sqrt(p / 3) * s for s in PAULIS[1:]]


def depolarizing2(p: float) -> list[np.ndarray]:
    """The 2-qubit depolarizing channel's Kraus operators, on (a, b) with
    a the most significant bit."""
    pairs = [np.kron(a, b) for a in PAULIS for b in PAULIS][1:]
    return [math.sqrt(1 - p) * np.eye(4, dtype=np.complex128)] + \
        [math.sqrt(p / 15) * s for s in pairs]


#: a spec's channel name -> (its Kraus operators from p, the qubits it acts on)
CHANNELS = {"depolarizing": (depolarizing, 1), "dep": (depolarizing, 1),
            "depolarizing2": (depolarizing2, 2), "dep2": (depolarizing2, 2)}


def parse_noise(spec: str) -> list[tuple[list[np.ndarray], int]]:
    """``"depolarizing:0.0016,dep2:0.0062"`` -> [(Kraus operators, arity)]."""
    out = []
    for part in spec.split(","):
        name, _, value = part.strip().partition(":")
        make, arity = CHANNELS[name.strip().lower()]
        out.append((make(float(value)), arity))
    return out


def noisy_ops(gates, noise) -> list[tuple[list[np.ndarray], tuple[int, ...]]]:
    """The gates ``[(u, targets)]`` with the channels of ``noise``
    (:func:`parse_noise`) after each, as ``[(Kraus operators, targets)]``: a
    gate is the one operator u."""
    out = []
    for u, targets in gates:
        targets = tuple(targets)
        out.append(([np.asarray(u, dtype=np.complex128)], targets))
        for kraus, arity in noise:
            if arity == 1:
                out += [(kraus, (q,)) for q in targets]
            elif len(targets) == 2:
                out.append((kraus, targets))
    return out


def _left(k: torch.Tensor, m: torch.Tensor, targets, n: int) -> torch.Tensor:
    """K m for an operator K on ``targets`` of m's row index."""
    cols = m.shape[1]
    src, dst = list(targets), list(range(len(targets)))
    t = m.reshape([2] * n + [cols]).movedim(src, dst)
    shape = t.shape
    t = (k @ t.reshape(k.shape[1], -1)).reshape(shape)
    return t.movedim(dst, src).reshape(1 << n, cols)


@contextlib.contextmanager
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def evolve(n: int, ops, device="cpu") -> torch.Tensor:
    """The final (2^n, 2^n) complex64 rho of ``ops`` (:func:`noisy_ops`)
    from |0...0><0...0|."""
    rho = torch.zeros(1 << n, 1 << n, dtype=torch.complex64, device=device)
    rho[0, 0] = 1
    with _no_tf32():
        for kraus, targets in ops:
            new = torch.zeros_like(rho)
            for k in kraus:
                k = torch.as_tensor(np.asarray(k), dtype=torch.complex64, device=device)
                new += _left(k, _left(k, rho, targets, n).mH, targets, n).mH
            rho = new
    return rho
