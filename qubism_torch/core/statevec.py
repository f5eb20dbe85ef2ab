"""Typed state vectors with measurement.

The torch counterpart of reference src/Qubism/StateVec.hs: the 2^n complex
amplitudes are ONE contiguous complex64 tensor on ``config.device``. The
qubit count n is a plain Python int. Measurement and collapse update the
tensor in place; randomness is an explicit ``torch.Generator``.

Index convention is big-endian (qubit 0 = most significant index bit),
matching the reference's basis labeling (StateVec.hs:65-67).

Unlike the JAX package's immutable states, :meth:`collapse`,
:meth:`measure_qubit` and :meth:`measure` update the tensor in place (the
DSL's :class:`~qubism_torch.session.Session` owns a copy of its state, and
``Gate.__call__`` returns a new state).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import TOLERANCE
from ..ops import apply as _apply
from ..ops import measure as _measure
from .creg import CReg


class StateVec:
    """An n-qubit pure state held as one complex64 tensor."""

    __slots__ = ("n", "state")

    def __init__(self, n: int, state: torch.Tensor):
        if state.dtype != torch.complex64 or state.numel() != (1 << n):
            raise ValueError(f"state of {state.dtype} {tuple(state.shape)} is not "
                             f"2^{n} complex64 amplitudes")
        self.n = n
        self.state = state.reshape(-1)

    @classmethod
    def zero(cls, n: int) -> "StateVec":
        """|0...0> on n qubits."""
        return cls(n, _apply.zero_state(n))

    @classmethod
    def qubit(cls, alpha=1.0, beta=0.0) -> "StateVec":
        """A single qubit alpha|0> + beta|1> (normalized)."""
        return cls.from_amplitudes(np.array([alpha, beta], dtype=np.complex128)).normalize()

    @classmethod
    def from_amplitudes(cls, amps) -> "StateVec":
        """A state from a host amplitude vector of length 2^n, on
        ``config.device``."""
        amps = np.asarray(amps)
        n = int(amps.shape[0]).bit_length() - 1
        if amps.ndim != 1 or (1 << n) != amps.shape[0]:
            raise ValueError(f"length {amps.shape} is not a power of two")
        z = np.ascontiguousarray(amps, dtype=np.complex64)
        return cls(n, torch.from_numpy(z).to(_apply.device()))

    @property
    def amps(self) -> np.ndarray:
        """Host-side numpy complex128 amplitude vector."""
        return _apply.complex_from_state(self.state)

    @property
    def dimension(self) -> int:
        """Number of qubits (reference ``dimension``, StateVec.hs:74-75)."""
        return self.n

    def normalize(self) -> "StateVec":
        return StateVec(self.n, _apply.normalize(self.state))

    def tensor(self, other: "StateVec") -> "StateVec":
        """self ⊗ other: self's qubits become the most significant bits."""
        return StateVec(self.n + other.n, _apply.tensor(self.state, other.state))

    def inner(self, other: "StateVec") -> complex:
        """<self|other> (conjugate-linear in self)."""
        return complex(torch.vdot(self.state, other.state.to(self.state.device)).item())

    def norm(self) -> float:
        return float(torch.linalg.vector_norm(self.state))

    def adjoint(self) -> "StateVec":
        """Elementwise conjugate, the bra of this ket (reference ``adjoint``,
        src/Qubism/StateVec.hs:94-95)."""
        return StateVec(self.n, self.state.conj_physical())

    def expectation(self, pauli: str) -> float:
        """<psi|P|psi> for a Pauli string like "XZI..." (one char per
        qubit, I/X/Y/Z; qubit 0 = leftmost), as one chunked reduction
        (ops/measure.py:expectation_pauli)."""
        return _measure.expectation_pauli(self.state, self.n, pauli)

    def expectation_sum(self, terms) -> float:
        """<psi| sum_j c_j P_j |psi> for ``terms = [(coef, pauli), ...]``,
        the terms grouped by their flip mask."""
        return _measure.expectation_pauli_sum(self.state, self.n, terms)

    def reduced_density_matrix(self, subset) -> np.ndarray:
        """rho_A = Tr_B |psi><psi| for qubit subset A (host complex)."""
        from ..ops.rdm import reduced_density_matrix

        return reduced_density_matrix(self.state, self.n, subset)

    def entanglement_entropy(self, subset, base: float | None = None) -> float:
        """Von Neumann entropy of rho_A (nats; ``base=2`` for bits)."""
        from ..ops.rdm import entanglement_entropy

        return entanglement_entropy(self.state, self.n, subset, base)

    # -- amplitude queries -----------------------------------------------------

    def _basis_index(self, bits) -> int:
        """Basis index from an int, a '0110' string, or a bit sequence
        (qubit 0 first = most significant index bit, matching Show)."""
        if isinstance(bits, str):
            if len(bits) != self.n or set(bits) - {"0", "1"}:
                raise ValueError(f"bitstring {bits!r} is not {self.n} of 0/1")
            idx = int(bits, 2)
        elif isinstance(bits, (int, np.integer)):
            idx = int(bits)
        else:
            seq = list(bits)
            if len(seq) != self.n:
                raise ValueError(f"expected {self.n} bits, got {len(seq)}")
            idx = 0
            for b in seq:
                idx = (idx << 1) | (int(b) & 1)
        if not 0 <= idx < (1 << self.n):
            raise ValueError(f"basis index {idx} out of range for n={self.n}")
        return idx

    def amplitude(self, bits) -> complex:
        """One amplitude <b|psi>: a scalar read, not a 2^n transfer."""
        return complex(self.state[self._basis_index(bits)].item())

    def probability(self, bits) -> float:
        """Born probability |<b|psi>|^2 of one basis state."""
        a = self.amplitude(bits)
        return a.real * a.real + a.imag * a.imag

    def probs(self) -> np.ndarray:
        """The full Born distribution as a host (2^n,) float64 array;
        refused past n = 26 (a multi-GiB host transfer)."""
        if self.n > 26:
            raise ValueError(
                f"probs() materializes 2^{self.n} host floats; sample() or "
                f"probability(bits) scale to large n")
        a = self.amps
        return a.real * a.real + a.imag * a.imag

    def prob_one(self, i: int) -> float:
        return _measure.prob_one(self.state, i, self.n)

    def collapse(self, i: int, outcome) -> "StateVec":
        """Project qubit i onto outcome (0/1) and renormalize, in place
        (reference ``collapse``, StateVec.hs:104-114)."""
        _measure.collapse(self.state, int(outcome), i, self.n)
        return self

    def measure_qubit(self, i: int, gen: torch.Generator | None) -> int:
        """Sample qubit i and collapse in place. Returns the bit."""
        return _measure.measure_qubit(self.state, gen, i, self.n)

    def measure(self, gen: torch.Generator | None) -> CReg:
        """Measure every qubit in index order with collapse-as-you-go
        semantics (reference ``measure``, StateVec.hs:133-137), in place."""
        return CReg.of(_measure.measure_qubits(self.state, gen, tuple(range(self.n)), self.n))

    def sample(self, shots: int, gen: torch.Generator | None = None,
               seed: int | None = None) -> dict[str, int]:
        """Non-destructive shot sampling: {bitstring: count}."""
        from ..ops import sample as _sample

        if gen is None:
            gen = torch.Generator().manual_seed(0 if seed is None else seed)
        return _sample.sample_counts(self.state, self.n, shots, gen)

    def __eq__(self, other) -> bool:
        """Approximate equality: L2 distance < 1e-6 (StateVec.hs:47-49)."""
        if not isinstance(other, StateVec):
            return NotImplemented
        if other.n != self.n:
            return False
        d = self.state - other.state.to(self.state.device)
        return float(torch.linalg.vector_norm(d)) < TOLERANCE

    def __hash__(self):  # pragma: no cover - states are not hashable
        raise TypeError("StateVec is unhashable (approximate equality)")

    def __repr__(self) -> str:
        return f"StateVec(n={self.n})\n{self}"

    def __str__(self) -> str:
        """Pretty amplitude list with basis kets, matching the reference's
        Show instance (StateVec.hs:60-68): '% 6.4f  + % 6.4fi  |bits>'."""
        zs = self.amps
        lines = []
        for i, z in enumerate(zs):
            ket = format(i, f"0{self.n}b") if self.n else ""
            lines.append(f"{z.real: 6.4f}  + {z.imag: 6.4f}i  |{ket}>")
        return "\n".join(lines) + ("\n" if len(zs) else "")


def mk_state_vec(n: int) -> StateVec:
    """|0...0> on n qubits (reference ``mkStateVec``)."""
    return StateVec.zero(n)


def mk_qubit() -> StateVec:
    """A |0> qubit (reference ``mkQubit``)."""
    return StateVec.zero(1)
