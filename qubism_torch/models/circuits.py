"""Benchmark / example circuit families.

Prim streams for the compiled engine (``CompiledCircuit(n, qft_prims(n))``):
QFT, GHZ, random brickwork, Grover, the W state, QAOA MaxCut and phase
estimation, plus :func:`prims_qasm`, which exports any such stream to
OpenQASM. OpenQASM 2.0 text for the file path: the families of
BASELINE.json's configs (QFT, GHZ, random brickwork, the widened Cuccaro
adder), and Grover (ccx-cascade oracle with ancillas), the W state, QAOA
MaxCut and phase estimation in qelib1 gates. Each text includes ``qelib1.inc``, so it is parsed under a path
inside ``examples/``. Host numpy only, as in qubism_tpu/models/circuits.py.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.gates import Prim, u3_matrix

_H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / math.sqrt(2)
_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_CNOT = np.array(
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=np.complex128
)


def _cu1_diag(lam: float) -> np.ndarray:
    return np.array([1, 1, 1, np.exp(1j * lam)], dtype=np.complex128)


def _cz_diag() -> np.ndarray:
    return np.array([1, 1, 1, -1], dtype=np.complex128)


# -- prim streams -----------------------------------------------------------------


def qft_prims(n: int) -> list[Prim]:
    """Textbook QFT (fourier.qasm generalized to n qubits): H on each qubit
    interleaved with controlled-phase ladders, the stage shape the fusion's
    stage blocks apply in one pass per block."""
    prims: list[Prim] = []
    for q in range(n):
        prims.append(Prim(_H, (q,)))
        for j in range(q + 1, n):
            prims.append(Prim(_cu1_diag(math.pi / (1 << (j - q))), (j, q), diag=True))
    return prims


def ghz_prims(n: int) -> list[Prim]:
    prims = [Prim(_H, (0,))]
    for i in range(n - 1):
        prims.append(Prim(_CNOT, (i, i + 1)))
    return prims


def brickwork_prims(n: int, depth: int, seed: int = 0) -> list[Prim]:
    """Random-circuit sampling workload: layers of random u3s followed by a
    brick pattern of CZs (diagonal: one pass per layer). Draws the same
    angles as :func:`brickwork_qasm` for the same seed."""
    rng = np.random.default_rng(seed)
    prims: list[Prim] = []
    for layer in range(depth):
        for q in range(n):
            th, ph, lm = rng.uniform(0, 2 * math.pi, size=3)
            prims.append(Prim(u3_matrix(th, ph, lm, reference_bug=False), (q,)))
        for q in range(layer % 2, n - 1, 2):
            prims.append(Prim(_cz_diag(), (q, q + 1), diag=True))
    return prims


def grover_prims(n: int, marked: int, iterations: int | None = None) -> list[Prim]:
    """Grover search for basis state ``marked``: each oracle / diffusion
    reflection is ONE diagonal prim over the whole register (a diagonal
    factor, not the ancilla ccx cascade of a gate-model circuit). Demo
    scale (n <= 16): Grover's useful depth grows as 2^(n/2) anyway."""
    if not 2 <= n <= 16:
        raise ValueError("grover_prims is demo-scale: 2 <= n <= 16")
    if iterations is None:
        iterations = max(1, int(math.floor(math.pi / 4 * math.sqrt(1 << n))))
    prims: list[Prim] = [Prim(_H, (q,)) for q in range(n)]
    for _ in range(iterations):
        prims.append(_phase_flip_prim(n, marked))
        prims.extend(Prim(_H, (q,)) for q in range(n))
        prims.append(_phase_flip_prim(n, 0))
        prims.extend(Prim(_H, (q,)) for q in range(n))
    return prims


def _phase_flip_prim(n: int, basis: int) -> Prim:
    """-1 phase on one basis state: a full-register diagonal prim."""
    d = np.ones(1 << n, dtype=np.complex128)
    d[basis] = -1
    return Prim(d, tuple(range(n)), diag=True)


def _w_angles(n: int) -> list[tuple[float, float]]:
    """(cos, sin) per cascade step: after step i the excitation amplitude
    remaining on q[i] is 1/sqrt(n) and sqrt((n-i-1)/n) moves on."""
    out = []
    for i in range(n - 1):
        c = 1.0 / math.sqrt(n - i)
        out.append((c, math.sqrt(1.0 - c * c)))
    return out


def w_state_prims(n: int) -> list[Prim]:
    """|W_n> via the rotation cascade: X on q0, then per step a 2q rotation
    in the {|01>, |10>} subspace splitting the excitation onto q[i+1]."""
    prims = [Prim(_X, (0,))]
    for i, (c, s) in enumerate(_w_angles(n)):
        m = np.array([[1, 0, 0, 0],
                      [0, c, s, 0],
                      [0, -s, c, 0],
                      [0, 0, 0, 1]], dtype=np.complex128)
        prims.append(Prim(m, (i, i + 1)))
    return prims


def ring_edges(n: int) -> list[tuple[int, int]]:
    if n < 2:
        return []
    if n == 2:
        return [(0, 1)]  # the wrap-around would duplicate the one edge
    return [(i, (i + 1) % n) for i in range(n)]


def qaoa_prims(n: int, edges, gammas, betas) -> list[Prim]:
    """p-layer QAOA MaxCut ansatz: an H layer, then per layer the cost
    e^{-i gamma Z_i Z_j} on every edge (2q diagonals: one diag pass) and the
    rx(2 beta) mixer (a disjoint 1q layer)."""
    if len(gammas) != len(betas):
        raise ValueError("qaoa_prims: one gamma per beta")
    prims: list[Prim] = [Prim(_H, (q,)) for q in range(n)]
    for gamma, beta in zip(gammas, betas):
        zz = np.exp(-1j * gamma * np.array([1, -1, -1, 1]))
        for i, j in edges:
            prims.append(Prim(zz, (min(i, j), max(i, j)), diag=True))
        c, s = math.cos(beta), math.sin(beta)
        rx = np.array([[c, -1j * s], [-1j * s, c]], dtype=np.complex128)
        prims.extend(Prim(rx, (q,)) for q in range(n))
    return prims


def qaoa_maxcut_energy(state, n: int, edges) -> float:
    """MaxCut objective <sum_edges (1 - Z_i Z_j)/2> as one Pauli sum whose
    terms all share the empty flip mask (one pass over |psi|^2). Accepts a
    StateVec, a ShardedSim or a DensityMatrix (anything with
    ``expectation_sum``), or a state tensor."""
    from ..ops.measure import expectation_pauli_sum

    terms = []
    for i, j in edges:
        p = ["I"] * n
        p[i] = p[j] = "Z"
        terms.append((-0.5, "".join(p)))
    const = 0.5 * len(edges)
    if hasattr(state, "expectation_sum"):
        return const + state.expectation_sum(terms)
    return const + expectation_pauli_sum(state, n, terms)


def qpe_prims(t: int, phi: float) -> list[Prim]:
    """Textbook phase estimation of the eigenphase ``phi`` (in turns) of
    diag(1, e^{2 pi i phi}), with t counting qubits and the eigenstate on
    qubit t (prepared in |1>). The circuit QFT has no final swaps, so
    counting qubit q carries weight 2^q; measuring qubits 0..t-1
    big-endian yields round(phi * 2^t) with high probability."""
    prims: list[Prim] = [Prim(_X, (t,))]
    prims.extend(Prim(_H, (q,)) for q in range(t))
    for q in range(t):
        prims.append(Prim(_cu1_diag(2.0 * math.pi * phi * (1 << q)), (q, t), diag=True))
    # inverse QFT on the counting register (reversed conjugated QFT)
    for q in range(t - 1, -1, -1):
        for j in range(t - 1, q, -1):
            prims.append(Prim(_cu1_diag(-math.pi / (1 << (j - q))), (j, q), diag=True))
        prims.append(Prim(_H, (q,)))
    return prims


def _zyz_u3(u: np.ndarray) -> tuple[float, float, float]:
    """(theta, phi, lam) with u = e^{i global} * u3(theta, phi, lam) for any
    2x2 unitary (the global phase is dropped)."""
    a00, a01, a10 = u[0, 0], u[0, 1], u[1, 0]
    theta = 2.0 * math.atan2(abs(a10), abs(a00))
    if abs(a00) < 1e-12:      # theta = pi: m00 = 0, the phase split is free
        return math.pi, float(np.angle(a10) - np.angle(-a01)), 0.0
    if abs(a10) < 1e-12:      # theta = 0: diagonal, one u1 worth of phase
        return 0.0, 0.0, float(np.angle(u[1, 1]) - np.angle(a00))
    phi = float(np.angle(a10) - np.angle(a00))
    lam = float(np.angle(-a01) - np.angle(a00))
    return theta, phi, lam


def _diag_phase_lines(phases, qs) -> list[str]:
    """qelib1 lines realizing diag(e^{i phases}) on 1 or 2 qubits (up to a
    global phase): u1s plus one cu1 solve the phase system exactly."""
    if len(qs) == 1:
        return [f"u1({float(phases[1] - phases[0]):.12f}) q[{qs[0]}];"]
    a0, a1, a2, a3 = (float(p) for p in phases)
    q1, q2 = qs  # q1 = MSB of the local index
    lines = []
    if abs(a1 - a0) > 1e-12:
        lines.append(f"u1({a1 - a0:.12f}) q[{q2}];")
    if abs(a2 - a0) > 1e-12:
        lines.append(f"u1({a2 - a0:.12f}) q[{q1}];")
    z = a3 - a2 - a1 + a0
    if abs(z) > 1e-12:
        lines.append(f"cu1({z:.12f}) q[{q1}],q[{q2}];")
    return lines


def prims_qasm(n: int, prims, measure: bool = False) -> str:
    """Export a prim stream to OpenQASM 2.0 (qelib1 gates), correct up to a
    global phase: 1q unitaries via ZYZ (u3), 1-2q diagonals via u1/cu1,
    CNOT, SWAP and controlled-1q (cu3) for dense 2q gates. Raises
    ValueError for dense k > 2 gates or k > 2 diagonals (no local qelib1
    form)."""
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";', f"qreg q[{n}];"]
    if measure:
        lines.append(f"creg c[{n}];")
    swap = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]])
    for prim in prims:
        u = np.asarray(prim.u, dtype=np.complex128)
        qs = prim.targets
        if prim.diag:
            if len(qs) > 2:
                raise ValueError(f"no qelib1 form for a {len(qs)}q diagonal")
            # float32-built diagonals carry ~1e-7 noise
            if np.max(np.abs(np.abs(u) - 1.0)) > 1e-5:
                raise ValueError("diagonal is not unitary")
            lines.extend(_diag_phase_lines(np.angle(u), qs))
            continue
        if len(qs) == 1:
            th, ph, lm = _zyz_u3(u)
            lines.append(f"u3({th:.12f},{ph:.12f},{lm:.12f}) q[{qs[0]}];")
            continue
        if len(qs) != 2:
            raise ValueError(f"no qelib1 form for a dense {len(qs)}q gate")
        if np.allclose(u, _CNOT, atol=1e-9):
            lines.append(f"cx q[{qs[0]}],q[{qs[1]}];")
        elif np.allclose(u, swap, atol=1e-9):
            lines.append(f"cx q[{qs[0]}],q[{qs[1]}];")
            lines.append(f"cx q[{qs[1]}],q[{qs[0]}];")
            lines.append(f"cx q[{qs[0]}],q[{qs[1]}];")
        elif (np.allclose(u[:2, :2], np.eye(2), atol=1e-9)
              and np.allclose(u[:2, 2:], 0, atol=1e-9)
              and np.allclose(u[2:, :2], 0, atol=1e-9)):
            blk = u[2:, 2:]
            th, ph, lm = _zyz_u3(blk)
            # blk = e^{ig} u3(th, ph, lm); a controlled global phase is a u1
            # on the control, and qelib1's cu3 implements
            # controlled-[e^{-i(phi+lambda)/2} u3]: fold that phase in too
            g = float(np.angle(blk[0, 0]) if abs(blk[0, 0]) > 1e-12
                      else np.angle(-blk[0, 1]))
            g += (ph + lm) / 2.0
            lines.append(f"cu3({th:.12f},{ph:.12f},{lm:.12f}) q[{qs[0]}],q[{qs[1]}];")
            if abs(g) > 1e-12:
                lines.append(f"u1({g:.12f}) q[{qs[0]}];")
        else:
            raise ValueError("no qelib1 form for a generic dense 2q gate")
    if measure:
        lines.append("measure q -> c;")
    return "\n".join(lines) + "\n"


# -- OpenQASM text ------------------------------------------------------------------


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


def grover_qasm(n: int, marked: int, iterations: int | None = None,
                measure: bool = True) -> str:
    """Grover search for basis state ``marked`` on n qubits via the
    textbook oracle + diffusion circuit: multi-controlled Z built from a
    ccx cascade over n-2 ancillas (qelib1 gates only, so the file runs
    through the interpreter unchanged). ``examples/grover.qasm`` is
    ``grover_qasm(3, 5)``."""
    if not 2 <= n:
        raise ValueError("grover needs n >= 2")
    if iterations is None:
        iterations = max(1, int(math.floor(math.pi / 4 * math.sqrt(1 << n))))
    anc = max(n - 2, 0)
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";', f"qreg q[{n}];"]
    if anc:
        lines.append(f"qreg anc[{anc}];")
    lines.append(f"creg c[{n}];")

    def mcz() -> list[str]:
        """Z on q[n-1] controlled on q[0..n-2] (an h sandwich turns the
        cascade's final cx/ccx into cz)."""
        if n == 2:
            return ["cz q[0],q[1];"]
        out = [f"h q[{n - 1}];", "ccx q[0],q[1],anc[0];"]
        for i in range(2, n - 1):
            out.append(f"ccx q[{i}],anc[{i - 2}],anc[{i - 1}];")
        out.append(f"cx anc[{n - 3}],q[{n - 1}];")
        for i in range(n - 2, 1, -1):
            out.append(f"ccx q[{i}],anc[{i - 2}],anc[{i - 1}];")
        out.append("ccx q[0],q[1],anc[0];")
        out.append(f"h q[{n - 1}];")
        return out

    for q in range(n):
        lines.append(f"h q[{q}];")
    for _ in range(iterations):
        # oracle: phase-flip |marked>
        offs = [q for q in range(n) if not ((marked >> (n - 1 - q)) & 1)]
        for q in offs:
            lines.append(f"x q[{q}];")
        lines.extend(mcz())
        for q in offs:
            lines.append(f"x q[{q}];")
        # diffusion: reflect about the uniform state
        for q in range(n):
            lines.append(f"h q[{q}];")
            lines.append(f"x q[{q}];")
        lines.extend(mcz())
        for q in range(n):
            lines.append(f"x q[{q}];")
            lines.append(f"h q[{q}];")
    if measure:
        lines.append("measure q -> c;")
    return "\n".join(lines) + "\n"


def w_state_qasm(n: int, measure: bool = True) -> str:
    """The :func:`w_state_prims` cascade in qelib1 gates: cu3(theta,0,0) =
    controlled-ry splits the excitation onto q[i+1], cx moves it off q[i]."""
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";', f"qreg q[{n}];",
             f"creg c[{n}];", "x q[0];"]
    for i, (c, s) in enumerate(_w_angles(n)):
        theta = 2.0 * math.atan2(s, c)
        lines.append(f"cu3({theta:.12f},0,0) q[{i}],q[{i + 1}];")
        lines.append(f"cx q[{i + 1}],q[{i}];")
    if measure:
        lines.append("measure q -> c;")
    return "\n".join(lines) + "\n"


def qaoa_qasm(n: int, edges, gammas, betas, measure: bool = True) -> str:
    """:func:`qaoa_prims` in qelib1 gates (the cost up to a global phase)."""
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";', f"qreg q[{n}];",
             f"creg c[{n}];"]
    for q in range(n):
        lines.append(f"h q[{q}];")
    for gamma, beta in zip(gammas, betas):
        for i, j in edges:
            # e^{-i gamma Z_i Z_j} = cx; rz(2 gamma); cx  (global phase off)
            lines.append(f"cx q[{i}],q[{j}];")
            lines.append(f"rz({2 * gamma:.12f}) q[{j}];")
            lines.append(f"cx q[{i}],q[{j}];")
        for q in range(n):
            lines.append(f"rx({2 * beta:.12f}) q[{q}];")
    if measure:
        lines.append("measure q -> c;")
    return "\n".join(lines) + "\n"


def qpe_qasm(t: int, phi: float, measure: bool = True) -> str:
    """:func:`qpe_prims` in qelib1 gates: counting register ``q[t]``, the
    eigenqubit ``e[0]``."""
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";', f"qreg q[{t}];",
             "qreg e[1];", f"creg c[{t}];", "x e[0];"]
    for q in range(t):
        lines.append(f"h q[{q}];")
    for q in range(t):
        lam = 2.0 * math.pi * phi * (1 << q)
        lines.append(f"cu1({lam:.12f}) q[{q}],e[0];")
    for q in range(t - 1, -1, -1):
        for j in range(t - 1, q, -1):
            lines.append(f"cu1(-pi/{1 << (j - q)}) q[{j}],q[{q}];")
        lines.append(f"h q[{q}];")
    if measure:
        lines.append("measure q -> c;")
    return "\n".join(lines) + "\n"
