"""Stateful DSL session: the Python mirror of the reference's
``StateT (StateVec n) m`` computations (examples/Teleportation.hs:20-29).

A :class:`Session` owns a copy of a StateVec and a seeded CPU
``torch.Generator`` and updates them in place, so circuits with
mid-circuit measurement and classical feed-forward read naturally:

    import qubism_torch as qt

    s = qt.Session(qt.mk_state_vec(3), seed=0)
    s.gate(qt.cnot(0, 1, n=3))
    c0 = s.measure_qubit(0)
    s.gate(qt.if_bit(c0, qt.on_just(2, qt.pauli_z(), 3)))
"""

from __future__ import annotations

import torch

from .core.creg import CReg
from .core.gates import Gate
from .core.statevec import StateVec


class Session:
    """Owns a state vector and a generator; applies gates and measurements."""

    def __init__(self, sv: StateVec, seed: int | None = None,
                 gen: torch.Generator | None = None):
        if gen is None:
            gen = torch.Generator().manual_seed(0 if seed is None else seed)
        self.sv = StateVec(sv.n, sv.state.clone())
        self.gen = gen

    @property
    def n(self) -> int:
        return self.sv.n

    def gate(self, g: Gate) -> "Session":
        """Apply a gate (reference ``gate``, QGate.hs:83-84)."""
        if g.n != self.n:
            raise ValueError(f"gate on {g.n} qubits applied to {self.n}-qubit state")
        g.apply_(self.sv.state)
        return self

    def measure_qubit(self, i: int) -> int:
        """Sample qubit i, collapse the state, return the classical bit."""
        return self.sv.measure_qubit(i, self.gen)

    def measure(self) -> CReg:
        """Measure all qubits sequentially (reference ``measure``)."""
        return self.sv.measure(self.gen)

    def expectation(self, pauli: str) -> float:
        """<psi|P|psi> for a Pauli string (non-destructive)."""
        return self.sv.expectation(pauli)

    def expectation_sum(self, terms) -> float:
        """<psi| sum_j c_j P_j |psi> for ``[(coef, pauli), ...]``
        (non-destructive)."""
        return self.sv.expectation_sum(terms)

    def state(self) -> StateVec:
        return self.sv
