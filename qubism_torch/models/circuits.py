"""Benchmark / example circuit families as OpenQASM 2.0 text.

The families of BASELINE.json's configs: QFT, GHZ, random brickwork and the
widened Cuccaro adder. Each text includes ``qelib1.inc``, so it is parsed
under a path inside ``examples/``.
"""

from __future__ import annotations

import math

import numpy as np


def qft_qasm(n: int, measure: bool = True, inputs: tuple[int, ...] = ()) -> str:
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";', f"qreg q[{n}];", f"creg c[{n}];"]
    for q in inputs:
        lines.append(f"x q[{q}];")
    for q in range(n):
        lines.append(f"h q[{q}];")
        for j in range(q + 1, n):
            lines.append(f"cu1(pi/{1 << (j - q)}) q[{j}],q[{q}];")
    if measure:
        lines.append("measure q -> c;")
    return "\n".join(lines) + "\n"


def ghz_qasm(n: int, measure: bool = True) -> str:
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";', f"qreg q[{n}];", f"creg c[{n}];",
             "h q[0];"]
    for i in range(n - 1):
        lines.append(f"cx q[{i}],q[{i + 1}];")
    if measure:
        lines.append("measure q -> c;")
    return "\n".join(lines) + "\n"


def brickwork_qasm(n: int, depth: int, seed: int = 0, measure: bool = True) -> str:
    """Layers of random u3 gates followed by a brick pattern of CZs."""
    rng = np.random.default_rng(seed)
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";', f"qreg q[{n}];", f"creg c[{n}];"]
    for layer in range(depth):
        for q in range(n):
            th, ph, lm = rng.uniform(0, 2 * math.pi, size=3)
            lines.append(f"u3({th:.12f},{ph:.12f},{lm:.12f}) q[{q}];")
        for q in range(layer % 2, n - 1, 2):
            lines.append(f"cz q[{q}],q[{q + 1}];")
    if measure:
        lines.append("measure q -> c;")
    return "\n".join(lines) + "\n"


def adder_qasm(width: int, a_val: int, b_val: int) -> str:
    """rippleCarryAdder.qasm widened to ``width``-bit operands
    (BASELINE.json configs[3]): computes b := a + b, cout = carry."""
    lines = [
        "OPENQASM 2.0;",
        'include "qelib1.inc";',
        "gate majority a,b,c { cx c,b; cx c,a; ccx a,b,c; }",
        "gate unmaj a,b,c { ccx a,b,c; cx c,a; cx a,b; }",
        "qreg cin[1];",
        f"qreg a[{width}];",
        f"qreg b[{width}];",
        "qreg cout[1];",
        f"creg ans[{width + 1}];",
    ]
    for i in range(width):
        if (a_val >> i) & 1:
            lines.append(f"x a[{i}];")
        if (b_val >> i) & 1:
            lines.append(f"x b[{i}];")
    lines.append("majority cin[0],b[0],a[0];")
    for i in range(1, width):
        lines.append(f"majority a[{i - 1}],b[{i}],a[{i}];")
    lines.append(f"cx a[{width - 1}],cout[0];")
    for i in range(width - 1, 0, -1):
        lines.append(f"unmaj a[{i - 1}],b[{i}],a[{i}];")
    lines.append("unmaj cin[0],b[0],a[0];")
    for i in range(width):
        lines.append(f"measure b[{i}] -> ans[{i}];")
    lines.append(f"measure cout[0] -> ans[{width}];")
    return "\n".join(lines) + "\n"
