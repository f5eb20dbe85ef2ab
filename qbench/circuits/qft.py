"""The quantum Fourier transform on a basis-state input, as MQT Bench's
algorithm-level "qft" (Qiskit's ``QFT``) has it: H and controlled phases,
then the final swaps that put the output in natural order.

Without its swaps it is a frozen copy of
``qubism_torch.models.circuits.qft_qasm`` (with its ``inputs``) and
``qft_prims``. Each swap is written as qelib1's ``swap`` of Qiskit (three
cx), declared in the text, since the OpenQASM 2.0 qelib1.inc has none. Each
program is the transform of one basis state |x>, x drawn from the program's
seed. Qubit q is bit n-1-q of a basis index, as in the OpenQASM text's
counts.

A gate list is ``[(u, targets, diag), ...]``: a (2^k, 2^k) matrix, or the
(2^k,) diagonal when ``diag``, on ``targets`` (targets[0] the most
significant bit of u's index).
"""

from __future__ import annotations

import math

import numpy as np

_H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / math.sqrt(2)
_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_SWAP = np.eye(4, dtype=np.complex128)[[0, 2, 1, 3]]
SWAP_GATE = "gate swap a,b { cx a,b; cx b,a; cx a,b; }"


def draw(cfg: dict, seed: int) -> dict:
    """A program's parameters from its seed: the input basis index x."""
    n = cfg["num_qubits"]
    return {"x": int(np.random.default_rng(seed).integers(0, 1 << n))}


def _inputs(n: int, x: int) -> tuple[int, ...]:
    """The qubits that read 1 in basis index x."""
    return tuple(q for q in range(n) if (x >> (n - 1 - q)) & 1)


def basis(cfg: dict, p: dict) -> int:
    """The program's input basis index."""
    return p["x"]


def text(cfg: dict, p: dict) -> str:
    """The program as OpenQASM 2.0: x gates for the input, then the QFT and
    its swaps. No measurement: the shots measure every qubit."""
    n = cfg["num_qubits"]
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";', SWAP_GATE, f"qreg q[{n}];",
             f"creg c[{n}];"]
    for q in _inputs(n, p["x"]):
        lines.append(f"x q[{q}];")
    for q in range(n):
        lines.append(f"h q[{q}];")
        for j in range(q + 1, n):
            lines.append(f"cu1(pi/{1 << (j - q)}) q[{j}],q[{q}];")
    lines += [f"swap q[{q}],q[{n - 1 - q}];" for q in range(n // 2)]
    return "\n".join(lines) + "\n"


def body(cfg: dict) -> list:
    """The QFT's gate list: H on each qubit, each followed by its ladder of
    controlled phases, then the swaps."""
    n = cfg["num_qubits"]
    gates = []
    for q in range(n):
        gates.append((_H, (q,), False))
        for j in range(q + 1, n):
            lam = math.pi / (1 << (j - q))
            gates.append((np.array([1, 1, 1, np.exp(1j * lam)], dtype=np.complex128),
                          (j, q), True))
    return gates + [(_SWAP, (q, n - 1 - q), False) for q in range(n // 2)]


def gates(cfg: dict, p: dict) -> list:
    """The whole program from |0...0>: the input's x gates, then the QFT."""
    return [(_X, (q,), False) for q in _inputs(cfg["num_qubits"], p["x"])] + body(cfg)


def closed_form(cfg: dict, p: dict, idx: np.ndarray) -> np.ndarray:
    """The output amplitudes at basis indices ``idx`` (complex128):
    2^(-n/2) exp(2 pi i x k / 2^n). The phase is taken modulo 2^n in
    integers, so it is exact at any n < 32."""
    n = cfg["num_qubits"]
    k = np.asarray(idx, dtype=np.uint64)
    m = (np.uint64(p["x"]) * k) & np.uint64((1 << n) - 1)
    return np.exp(2j * np.pi * m.astype(np.float64) / (1 << n)) / math.sqrt(1 << n)
