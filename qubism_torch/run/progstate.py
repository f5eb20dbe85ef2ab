"""Interpreter state: registers, state vectors, user gates.

Counterpart of reference src/Qubism/QASM/ProgState.hs. Key design point
carried over (ProgState.hs:42-46, 137-166): a **QReg is a view** — a
(backing-statevec id, qubit offset, size) triple — and independent qregs live
in separate state vectors until a cross-register operation *fuses* them into
one (named "a(x)b"). Memory and time therefore scale with the largest
entangled cluster, not the total declared qubit count.

Differences from the reference (all deliberate, see config module docs):

* randomness is an explicit seeded ``torch.Generator`` stored in the state
  (reproducible);
* state updates always go to the *backing* state vector — the reference
  orphans single-qubit-gate updates on fused registers by writing them under
  the QReg's name (Simulation.hs:100);
* ``ProgState.copy()`` clones the state tensors: the kernels update them in
  place (the JAX package's appliers return new arrays), so a copy that shared
  them would let a failed REPL line corrupt the state that is kept.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..core.creg import CReg
from ..core.statevec import StateVec
from ..qasm.ast import SourcePos, UnitaryOp

_INITIAL_POS = SourcePos("", 1, 1)


class QasmRuntimeError(Exception):
    """Runtime error carrying QASM source position (ProgState.hs:97-103)."""

    def __init__(self, pos: SourcePos, message: str):
        self.pos = pos
        self.message = message
        super().__init__(str(self))

    def __str__(self) -> str:
        return f"ERROR on line {self.pos.line} in {self.pos.file}\n{self.message}"


@dataclass(frozen=True)
class QRegView:
    """A quantum register as a view into a backing state vector."""

    target: str  # id of the backing StateVec
    start: int   # index of the register's first qubit within it
    size: int


@dataclass(frozen=True)
class CustomGate:
    params: tuple[str, ...]
    args: tuple[str, ...]
    #: None = an ``opaque`` declaration (spec gate with no body):
    #: resolvable by name, a runtime error to apply
    body: tuple[UnitaryOp, ...] | None


@dataclass
class ProgState:
    stvecs: dict[str, StateVec] = field(default_factory=dict)
    qregs: dict[str, QRegView] = field(default_factory=dict)
    cregs: dict[str, CReg] = field(default_factory=dict)
    funcs: dict[str, CustomGate] = field(default_factory=dict)
    pos: SourcePos = _INITIAL_POS
    gen: torch.Generator | None = None

    def copy(self) -> "ProgState":
        """A copy with its own state tensors and its own generator."""
        gen = None
        if self.gen is not None:
            gen = torch.Generator()
            gen.set_state(self.gen.get_state())
        return ProgState(
            {k: StateVec(sv.n, sv.state.clone()) for k, sv in self.stvecs.items()},
            dict(self.qregs), dict(self.cregs),
            dict(self.funcs), self.pos, gen,
        )

    # -- errors ---------------------------------------------------------------

    def runtime_error(self, msg: str):
        raise QasmRuntimeError(self.pos, msg)

    def find(self, name: str, table: dict):
        try:
            return table[name]
        except KeyError:
            self.runtime_error(f"Undeclared identifier: {name}")

    def check_name_conflict(self, name: str, table: dict):
        if name in table:
            self.runtime_error(f"Redeclaration of {name}")

    # -- registers (ProgState.hs:174-246) ----------------------------------------

    def add_qreg(self, name: str, size: int):
        self.check_name_conflict(name, self.qregs)
        self.qregs[name] = QRegView(name, 0, size)
        self.add_statevec(name, size)

    def add_creg(self, name: str, size: int):
        self.check_name_conflict(name, self.cregs)
        self.cregs[name] = CReg.zeros(size)

    def write_creg(self, creg: CReg, name: str):
        old = self.find(name, self.cregs)
        if creg.size != old.size:
            self.runtime_error(f"Mismatched size on overwrite of {name}")
        self.cregs[name] = creg

    def write_bit(self, b, name: str, i: int):
        cr = self.find(name, self.cregs)
        if not i < cr.size:
            self.runtime_error(f"Index out of bounds when writing to {name}")
        self.cregs[name] = cr.set_bit(i, b)

    def add_statevec(self, name: str, size: int):
        self.check_name_conflict(name, self.stvecs)
        self.stvecs[name] = StateVec.zero(size)

    def delete_statevec(self, name: str):
        self.stvecs.pop(name, None)

    def add_func(self, cg: CustomGate, name: str):
        self.funcs[name] = cg

    def find_qr_size(self, name: str) -> int:
        return self.find(name, self.qregs).size

    # -- lazy register fusion (ProgState.hs:137-166) -------------------------------

    def fuse_qregs(self, qr1: str, qr2: str) -> str:
        """Tensor two registers' backing state vectors into one (named
        "sv1(x)sv2"), retargeting every QReg view. No-op if already fused.
        Returns the id of the (possibly new) backing state vector."""
        v1 = self.find(qr1, self.qregs)
        v2 = self.find(qr2, self.qregs)
        if v1.target == v2.target:
            return v1.target
        sv1 = self.find(v1.target, self.stvecs)
        sv2 = self.find(v2.target, self.stvecs)
        new_id = f"{v1.target}(x){v2.target}"
        self.stvecs[new_id] = sv1.tensor(sv2)
        shift1, shift2 = 0, sv1.n
        for name, view in list(self.qregs.items()):
            if view.target == v1.target:
                self.qregs[name] = QRegView(new_id, view.start + shift1,
                                            view.size)
            elif view.target == v2.target:
                self.qregs[name] = QRegView(new_id, view.start + shift2,
                                            view.size)
        self.delete_statevec(v1.target)
        self.delete_statevec(v2.target)
        return new_id

    # -- display (:dump, ProgState.hs:83-95) ----------------------------------------

    def pretty(self) -> str:
        out = ["Dump of the internal state: \n\n"]
        for name in sorted(self.stvecs):
            out.append(f"State Vector {name}:\n{self.stvecs[name]}")
        out.append("\n")
        for name in sorted(self.qregs):
            v = self.qregs[name]
            out.append(
                f"QReg {name}[{v.size}] -- targets state vector "
                f'"{v.target}" starting at qubit {v.start}\n'
            )
        out.append("\n")
        for name in sorted(self.cregs):
            cr = self.cregs[name]
            out.append(f"CReg {name}[{cr.size}] = {cr}\n")
        return "".join(out)


def blank_state(seed: int | None = None) -> ProgState:
    """Fresh interpreter state (reference ``blankState``, ProgState.hs:79-81)
    with a seeded generator (the reference had no seed control at all)."""
    return ProgState(gen=torch.Generator().manual_seed(0 if seed is None else seed))
