"""Typed state vectors with measurement.

The torch counterpart of reference src/Qubism/StateVec.hs: the 2^n complex
amplitudes are ONE contiguous complex64 tensor on ``config.device``. The
qubit count n is a plain Python int. Measurement and collapse update the
tensor in place; randomness is an explicit ``torch.Generator``.

Index convention is big-endian (qubit 0 = most significant index bit),
matching the reference's basis labeling (StateVec.hs:65-67).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import TOLERANCE
from ..ops import apply as _apply
from ..ops import measure as _measure


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

    @property
    def amps(self) -> np.ndarray:
        """Host-side numpy complex128 amplitude vector."""
        return _apply.complex_from_state(self.state)

    def tensor(self, other: "StateVec") -> "StateVec":
        """self ⊗ other: self's qubits become the most significant bits."""
        return StateVec(self.n + other.n, _apply.tensor(self.state, other.state))

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
