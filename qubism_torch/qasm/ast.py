"""OpenQASM 2.0 abstract syntax tree.

Mirrors the semantics of reference src/Qubism/QASM/AST.hs:18-67: statements,
quantum ops, unitary ops, arguments and the expression language — including
the reference's non-standard ``:dump`` debug statement (AST.hs:47).
An AST is a list of Stmt.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class SourcePos:
    file: str
    line: int
    col: int

    def __str__(self) -> str:
        return f"{self.file}:{self.line}:{self.col}"


# -- Expressions (AST.hs:58-67) ----------------------------------------------

class Expr:
    __slots__ = ()


@dataclass(frozen=True)
class Pi(Expr):
    pass


@dataclass(frozen=True)
class EIdent(Expr):
    name: str


@dataclass(frozen=True)
class Real(Expr):
    value: float


@dataclass(frozen=True)
class Binary(Expr):
    op: str  # add sub mul div pow
    lhs: Expr
    rhs: Expr


@dataclass(frozen=True)
class Unary(Expr):
    op: str  # neg sin cos tan exp ln sqrt
    arg: Expr


# -- Arguments (AST.hs:49-56) --------------------------------------------------

class Arg:
    __slots__ = ()


@dataclass(frozen=True)
class ArgBit(Arg):
    name: str
    index: int


@dataclass(frozen=True)
class ArgReg(Arg):
    name: str


def arg_id(a: Arg) -> str:
    """Reference ``argId`` (AST.hs:54-56)."""
    return a.name


# -- Unitary ops (AST.hs:41-47) ------------------------------------------------

class UnitaryOp:
    __slots__ = ()


@dataclass(frozen=True)
class U(UnitaryOp):
    theta: Expr
    phi: Expr
    lam: Expr
    arg: Arg


@dataclass(frozen=True)
class CX(UnitaryOp):
    control: Arg
    target: Arg


@dataclass(frozen=True)
class Func(UnitaryOp):
    name: str
    params: tuple[Expr, ...]
    args: tuple[Arg, ...]


@dataclass(frozen=True)
class Barrier(UnitaryOp):
    args: tuple[Arg, ...]


@dataclass(frozen=True)
class Dump(UnitaryOp):
    """Non-standard debug statement ``:dump`` (AST.hs:47)."""


# -- Quantum ops (AST.hs:35-39) -------------------------------------------------

class QuantumOp:
    __slots__ = ()


@dataclass(frozen=True)
class QUnitary(QuantumOp):
    op: UnitaryOp


@dataclass(frozen=True)
class Measure(QuantumOp):
    source: Arg
    target: Arg


@dataclass(frozen=True)
class Reset(QuantumOp):
    arg: Arg


# -- Statements (AST.hs:20-33) ---------------------------------------------------

class Stmt:
    __slots__ = ()


@dataclass(frozen=True)
class QRegDecl(Stmt):
    name: str
    size: int


@dataclass(frozen=True)
class CRegDecl(Stmt):
    name: str
    size: int


@dataclass(frozen=True)
class GateDecl(Stmt):
    name: str
    params: tuple[str, ...]
    args: tuple[str, ...]
    body: tuple[UnitaryOp, ...]


@dataclass(frozen=True)
class OpaqueDecl(Stmt):
    """``opaque name(params) qargs;`` — an OpenQASM 2.0 spec statement
    (arXiv:1707.03429 §4.1) the reference's grammar omits
    (src/Qubism/QASM/Parser.hs:134 has no ``opaque`` in rws): a gate
    declared with no body. Declaring is legal; *applying* it is a
    runtime error (a simulator has no unitary for it)."""

    name: str
    params: tuple[str, ...]
    args: tuple[str, ...]


@dataclass(frozen=True)
class QOp(Stmt):
    op: QuantumOp


@dataclass(frozen=True)
class UOp(Stmt):
    op: UnitaryOp


@dataclass(frozen=True)
class Cond(Stmt):
    creg: str
    value: int
    op: QuantumOp


@dataclass(frozen=True)
class StmtList(Stmt):
    stmts: tuple[Stmt, ...] = field(default_factory=tuple)


@dataclass(frozen=True)
class PosInfo(Stmt):
    pos: SourcePos
    stmt: Stmt


#: An OpenQASM program.
AST = list
