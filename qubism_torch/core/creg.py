"""Classical bits and registers.

Host-side, pure-Python value types (classical registers are tiny and live on
the host so that conditionals never force device round-trips beyond the
measurement itself). Mirrors reference src/Qubism/CReg.hs:

* ``CReg.to_natural`` is LSB-first: bit i contributes 2^i (CReg.hs:36-39).
  ``if (c == N)`` comparisons in QASM depend on this exact pairing.
* ``str(CReg)`` prints bits left-to-right with no separator (CReg.hs:24-25).
"""

from __future__ import annotations

from dataclasses import dataclass

ZERO = 0
ONE = 1


def bit(value) -> int:
    """Normalize any truthy/falsy or 0/1 value to a Bit (int 0 or 1)."""
    return 1 if int(value) else 0


@dataclass(frozen=True)
class CReg:
    """An immutable register of classical bits. bits[0] is bit 0."""

    bits: tuple[int, ...]

    @classmethod
    def zeros(cls, size: int) -> "CReg":
        return cls((0,) * size)

    @classmethod
    def of(cls, bits) -> "CReg":
        return cls(tuple(bit(b) for b in bits))

    @property
    def size(self) -> int:
        return len(self.bits)

    def to_natural(self) -> int:
        """LSB-first integer value: bit i contributes 2^i (CReg.hs:36-39)."""
        return sum(b << i for i, b in enumerate(self.bits))

    def set_bit(self, i: int, b) -> "CReg":
        if not (0 <= i < len(self.bits)):
            raise IndexError(f"bit index {i} out of range for CReg[{len(self.bits)}]")
        bs = list(self.bits)
        bs[i] = bit(b)
        return CReg(tuple(bs))

    def __getitem__(self, i: int) -> int:
        return self.bits[i]

    def __str__(self) -> str:
        return "".join(str(b) for b in self.bits)
