"""Quantum gates and combinators: the circuit DSL.

Counterpart of qubism_tpu/core/gates.py (after reference src/Qubism/QGate.hs).
A :class:`Prim` is a k-qubit unitary on explicit targets; a :class:`Gate` is
a circuit fragment, a sequence of prims on ``n`` qubits. Composition
concatenates sequences; application streams the prims through the appliers
of :mod:`qubism_torch.ops.apply` (the kernel wrappers), and
``CompiledCircuit(g.n, g.prims)`` runs the same stream fused. Dense
matrices are only materialized on demand (``Gate.matrix()``, small n).

Combinators: ``ident``, ``pauli_x/y/z``, ``hadamard``, ``phase``,
``unitary``, ``cnot``, ``swap``, ``controlled``, ``if_bit``, ``kronecker``,
``on_just``, ``on_every``, ``on_range``. ``a @ b`` is the matrix product (b
applies first), matching the reference Semigroup (QGate.hs:58-59);
``a.then(b)`` is the circuit-order alternative.
"""

from __future__ import annotations

import cmath
import math
from dataclasses import dataclass

import numpy as np

from ..config import TOLERANCE, config


@dataclass(frozen=True)
class Prim:
    """A primitive k-qubit unitary on explicit targets.

    ``u`` is a (2^k, 2^k) complex matrix, or the (2^k,) diagonal when
    ``diag`` is True. targets[0] is the most significant bit of the local
    index. Matrices are host-side numpy; they are shipped to the device at
    application time.
    """

    u: np.ndarray
    targets: tuple[int, ...]
    diag: bool = False

    def shifted(self, offset: int) -> "Prim":
        return Prim(self.u, tuple(t + offset for t in self.targets), self.diag)

    def remapped(self, mapping: dict[int, int]) -> "Prim":
        return Prim(self.u, tuple(mapping[t] for t in self.targets), self.diag)

    def dense(self) -> np.ndarray:
        return np.diag(self.u) if self.diag else self.u


class Gate:
    """A composable circuit fragment on ``n`` qubits."""

    __slots__ = ("n", "prims")

    def __init__(self, n: int, prims=()):
        prims = tuple(prims)
        for p in prims:
            if any(t < 0 or t >= n for t in p.targets):
                raise ValueError(f"prim targets {p.targets} out of range for n={n}")
            if len(set(p.targets)) != len(p.targets):
                raise ValueError(f"duplicate targets {p.targets}")
        self.n = n
        self.prims = prims

    # -- composition ---------------------------------------------------------

    def __matmul__(self, other: "Gate") -> "Gate":
        """Matrix-product composition: (a @ b)(psi) = a(b(psi)) (QGate.hs:58-59)."""
        if self.n != other.n:
            raise ValueError(f"gate sizes differ: {self.n} vs {other.n}")
        return Gate(self.n, other.prims + self.prims)

    def then(self, other: "Gate") -> "Gate":
        """Circuit-order composition: apply self first, then other."""
        return other @ self

    # -- application ---------------------------------------------------------

    def __call__(self, sv):
        """The gate applied to a StateVec: a new StateVec (the argument is
        left as it was)."""
        from .statevec import StateVec

        if sv.n != self.n:
            raise ValueError(f"gate on {self.n} qubits applied to {sv.n}-qubit state")
        return StateVec(self.n, self.apply_(sv.state.clone()))

    def apply_(self, state):
        """Apply the prims to a state tensor in place, one applier call each
        (ops.apply.apply_gate / apply_diag); returns the tensor."""
        from ..ops import apply as _apply

        for p in self.prims:
            if p.diag:
                _apply.apply_diag(state, p.u, p.targets, self.n)
            else:
                _apply.apply_gate(state, p.u, p.targets, self.n)
        return state

    # -- materialization & comparison -----------------------------------------

    def matrix(self, dtype=np.complex128) -> np.ndarray:
        """Dense 2^n x 2^n matrix on the host (tests / small n only), built
        column by column on ``config.device``."""
        import torch

        from ..ops import apply as _apply

        if self.n > 12:
            raise ValueError(
                f"Gate.matrix() materializes a dense 2^{self.n} x 2^{self.n} "
                f"matrix one column at a time — refusing past n=12. Apply "
                f"the gate to states instead (gate(state)).")
        dim = 1 << self.n
        cols = []
        for j in range(dim):
            e = torch.zeros(dim, dtype=torch.complex64, device=_apply.device())
            e[j] = 1
            cols.append(_apply.complex_from_state(self.apply_(e)))
        return np.stack(cols, axis=1).astype(dtype)

    def __eq__(self, other) -> bool:
        """Approximate equality via dense matrices, 1e-6 L2 (QGate.hs:54-56)."""
        if not isinstance(other, Gate) or other.n != self.n:
            return NotImplemented if not isinstance(other, Gate) else False
        d = self.matrix() - other.matrix()
        return float(np.linalg.norm(d)) < TOLERANCE

    def __hash__(self):  # pragma: no cover
        raise TypeError("Gate is unhashable (approximate equality)")

    def __repr__(self) -> str:
        ops = ", ".join(
            f"{'diag' if p.diag else 'u'}{len(p.targets)}@{p.targets}" for p in self.prims
        )
        return f"Gate(n={self.n}, [{ops}])"


# ---------------------------------------------------------------------------
# Matrices (host-side numpy; complex128 masters, cast at application time)
# ---------------------------------------------------------------------------

_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
_Z_DIAG = np.array([1, -1], dtype=np.complex128)
_H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / math.sqrt(2)
_CNOT = np.array(
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=np.complex128
)
_SWAP = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex128
)


def u3_matrix(theta: float, phi: float, lam: float, reference_bug: bool | None = None) -> np.ndarray:
    """The OpenQASM 2.0 U(theta, phi, lambda) matrix (arXiv:1707.03429 eq. 2).

    The reference's version (QGate.hs:112-118) is non-unitary for generic
    parameters (precedence/sign bug — see SURVEY.md §2.4.1); pass
    ``reference_bug=True`` (or set ``config.reference_u3_bug``) to replicate.
    """
    if reference_bug is None:
        reference_bug = config.reference_u3_bug
    ct, st = math.cos(theta / 2), math.sin(theta / 2)
    if reference_bug:
        a = cmath.exp(1j * (phi + lam / 2)) * ct
        b = -cmath.exp(1j * (phi - lam / 2)) * st
        c = cmath.exp(1j * (phi - lam / 2)) * st
        d = cmath.exp(1j * (phi + lam / 2)) * ct
    else:
        a = ct
        b = -cmath.exp(1j * lam) * st
        c = cmath.exp(1j * phi) * st
        d = cmath.exp(1j * (phi + lam)) * ct
    return np.array([[a, b], [c, d]], dtype=np.complex128)


def is_diagonal(u: np.ndarray) -> bool:
    return bool(np.allclose(u, np.diag(np.diag(u)), atol=1e-12))


# ---------------------------------------------------------------------------
# Gate constructors (QGate.hs:90-122)
# ---------------------------------------------------------------------------


def ident(n: int = 1) -> Gate:
    """The identity (reference ``ident`` / ``mempty``)."""
    return Gate(n, ())


def pauli_x() -> Gate:
    return Gate(1, (Prim(_X, (0,)),))


def pauli_y() -> Gate:
    return Gate(1, (Prim(_Y, (0,)),))


def pauli_z() -> Gate:
    return Gate(1, (Prim(_Z_DIAG, (0,), diag=True),))


def hadamard() -> Gate:
    return Gate(1, (Prim(_H, (0,)),))


def phase(lam: float) -> Gate:
    """diag(1, e^{i lam}), the spec-correct u1."""
    d = np.array([1, cmath.exp(1j * lam)], dtype=np.complex128)
    return Gate(1, (Prim(d, (0,), diag=True),))


def unitary(theta: float, phi: float, lam: float) -> Gate:
    """Parametrized 1-qubit gate U(theta, phi, lambda) (reference ``unitary``)."""
    u = u3_matrix(theta, phi, lam)
    if is_diagonal(u):
        return Gate(1, (Prim(np.diag(u).copy(), (0,), diag=True),))
    return Gate(1, (Prim(u, (0,)),))


def cnot(c: int, t: int, n: int | None = None) -> Gate:
    """Controlled-NOT with control c and target t (reference ``cnot``)."""
    n = max(c, t) + 1 if n is None else n
    return Gate(n, (Prim(_CNOT, (c, t)),))


def swap(a: int, b: int, n: int | None = None) -> Gate:
    n = max(a, b) + 1 if n is None else n
    return Gate(n, (Prim(_SWAP, (a, b)),))


# ---------------------------------------------------------------------------
# Combinators (QGate.hs:125-165)
# ---------------------------------------------------------------------------


def on_just(i: int, g: Gate, n: int) -> Gate:
    """Promote a 1-qubit gate to act on qubit i of an n-qubit register
    (reference ``onJust``, QGate.hs:148-154)."""
    if g.n != 1:
        raise ValueError("on_just expects a 1-qubit gate")
    return Gate(n, tuple(p.remapped({0: i}) for p in g.prims))


def on_every(g: Gate, n: int) -> Gate:
    """Apply a 1-qubit gate to every qubit (reference ``onEvery``)."""
    return on_range(0, n - 1, g, n)


def on_range(first: int, last: int, g: Gate, n: int) -> Gate:
    """Apply a 1-qubit gate to qubits first..last inclusive (``onRange``)."""
    prims = []
    for i in range(first, last + 1):
        prims.extend(p.remapped({0: i}) for p in g.prims)
    return Gate(n, tuple(prims))


def controlled(i: int, g: Gate) -> Gate:
    """Control every primitive of g on qubit i (reference ``controlled``).

    C(A·B) = C(A)·C(B) when the control is untouched by A and B, so
    controlling each primitive is exact."""
    prims = []
    for p in g.prims:
        if i in p.targets:
            raise ValueError(f"control qubit {i} overlaps gate targets {p.targets}")
        if p.diag:
            cu = np.concatenate([np.ones_like(p.u), p.u])
        else:
            dim = p.u.shape[0]
            cu = np.eye(2 * dim, dtype=np.complex128)
            cu[dim:, dim:] = p.u
        prims.append(Prim(cu, (i,) + p.targets, p.diag))
    return Gate(g.n, tuple(prims))


def if_bit(b, g: Gate) -> Gate:
    """Classical feed-forward: apply g iff the measured bit is 1
    (reference ``ifBit``, QGate.hs:136-137)."""
    return g if int(b) == 1 else ident(g.n)


def kronecker(a: Gate, b: Gate) -> Gate:
    """a ⊗ b: a acts on the first a.n qubits, b on the rest (``kronecker``)."""
    return Gate(a.n + b.n, a.prims + tuple(p.shifted(a.n) for p in b.prims))
