"""Random circuit sampling by the rules of Boixo et al., Nature Physics 14,
595 (2018), in their second version (github.com/sboixo/GRCS, cz_v2;
arXiv:1807.10749) as Cirq writes them in
``cirq.experiments.generate_boixo_2018_supremacy_circuits_v2_grid``:

1. a Hadamard on every qubit of a ``rows`` x ``cols`` lattice;
2. ``cz_depth`` cycles. Each is a layer of CZs on neighbours in one of
   eight patterns, taken in turn (a pattern with no pair on the lattice is
   skipped). On each qubit outside the layer: in the first cycle a T; later,
   sqrt(X) or sqrt(Y) at random where the qubit was in the previous cycle's
   CZ, and a T where the previous cycle put sqrt(X) or sqrt(Y) on it;
3. a Hadamard on every qubit.

Qubit (r, c) is q = r * cols + c, bit n-1-q of a basis index. sqrt(X) and
sqrt(Y) are written rx(pi/2) and ry(pi/2), which differ from them by a
global phase alone. Each program is a new circuit, drawn from its seed. A
gate list is as in :mod:`qft`'s.
"""

from __future__ import annotations

import math

import numpy as np

_S = 1 / math.sqrt(2)
MATRICES = {
    "h": (np.array([[1, 1], [1, -1]], dtype=np.complex128) * _S, False),
    "rx": (np.array([[1, -1j], [-1j, 1]], dtype=np.complex128) * _S, False),  # rx(pi/2)
    "ry": (np.array([[1, -1], [1, 1]], dtype=np.complex128) * _S, False),  # ry(pi/2)
    "t": (np.array([1, np.exp(1j * math.pi / 4)], dtype=np.complex128), True),
    "cz": (np.array([1, 1, 1, -1], dtype=np.complex128), True),
}
_QASM = {"h": "h", "rx": "rx(pi/2)", "ry": "ry(pi/2)", "t": "t", "cz": "cz"}
#: the cycle's pattern -> the pattern's index in the lattice's labelling
_ORDER = (0, 3, 2, 1, 4, 7, 6, 5)


def draw(cfg: dict, seed: int) -> dict:
    """A program's parameters from its seed: the circuit's own seed."""
    return {"seed": int(np.random.default_rng(seed).integers(0, 1 << 62))}


def cz_pattern(rows: int, cols: int, i: int) -> list[tuple[int, int]]:
    """The CZ pairs of pattern ``i`` (mod 8): horizontal pairs for even
    labels, vertical for odd, every fourth along the lattice's diagonal."""
    k = _ORDER[i % 8]
    dr, shift = k % 2, (k >> 1) % 4
    dc = 1 - dr
    return [(r * cols + c, (r + dr) * cols + c + dc)
            for r in range(rows - dr) for c in range(cols - dc)
            if (r * (2 - dr) + c * (2 - dc)) % 4 == shift]


def moments(cfg: dict, p: dict) -> list[list[tuple]]:
    """The circuit's moments, each a list of (gate name, qubits...)."""
    rows, cols = cfg["lattice"]
    n = rows * cols
    rng = np.random.default_rng(p["seed"])
    out = [[("h", q) for q in range(n)]]
    prev, pattern = {}, 0
    for cycle in range(cfg["cz_depth"]):
        pairs = []
        while not pairs:
            pairs, pattern = cz_pattern(rows, cols, pattern), pattern + 1
        now = {q: "cz" for pair in pairs for q in pair}
        ops = [("cz", a, b) for a, b in pairs]
        for q in range(n):
            if q in now:
                continue
            if cycle == 0:
                g = "t"
            elif prev.get(q) == "cz":
                g = ("rx", "ry")[int(rng.integers(2))]
            elif prev.get(q) in ("rx", "ry"):
                g = "t"
            else:
                continue
            ops.append((g, q))
            now[q] = g
        out.append(ops)
        prev = now
    out.append([("h", q) for q in range(n)])
    return out


def text(cfg: dict, p: dict) -> str:
    """The program as OpenQASM 2.0, moment by moment. No measurement: the
    shots measure every qubit of the final state."""
    n = cfg["num_qubits"]
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";', f"qreg q[{n}];", f"creg c[{n}];"]
    for ops in moments(cfg, p):
        lines += [f"{_QASM[g]} " + ",".join(f"q[{q}]" for q in qs) + ";" for g, *qs in ops]
    return "\n".join(lines) + "\n"


def gates(cfg: dict, p: dict) -> list:
    """The program's gate list from |0...0>."""
    return [(*MATRICES[g][:1], tuple(qs), MATRICES[g][1])
            for ops in moments(cfg, p) for g, *qs in ops]
