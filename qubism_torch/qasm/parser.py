"""Recursive-descent parser for OpenQASM 2.0.

Behavioral parity with reference src/Qubism/QASM/Parser.hs:

* optional ``OPENQASM 2.0;`` header (Parser.hs:184-189);
* statements separated by ``;`` **or** ``}`` — the closing brace of a gate
  declaration doubles as the statement terminator (Parser.hs:187-189), and a
  trailing separator after the last statement is optional;
* ``qreg``/``creg`` declarations; ``gate`` declarations whose params/args
  shadow the symbol table for the body and are restored afterwards
  (Parser.hs:209-223); empty gate bodies are legal;
* ``include "file"`` is a parse-time splice: the file (resolved relative to
  the *including* file's directory) is parsed recursively into a StmtList
  with the same symbol table (Parser.hs:225-253); a missing file renders as
  ``Cannot include: <file> does not exist``;
* ``measure a -> b``, ``reset``, ``U(θ,φ,λ) a``, ``CX a,b``, ``barrier``,
  user gate calls, the non-standard ``:dump``;
* ``if (creg == nat) qop`` conditionals;
* the expression grammar with precedence unary-minus > sin/cos/tan/exp/ln/
  sqrt > ``pow`` (a left-assoc *word*, not ``^``) > ``*``,``/`` > ``+``,``-``
  (Parser.hs:314-335);
* duplicate declaration and use of undeclared identifiers are **parse-time**
  errors (Parser.hs:154-160, 342-349); one global namespace across
  qregs/cregs/gates.

The parser symbol table is threaded incrementally for the REPL
(:func:`parse_openqasm_incremental` — reference ``parseOpenQASM'``,
Parser.hs:70-79): earlier declarations stay visible across lines, and a
failing line leaves the table untouched.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..utils import profiling
from . import ast as A
from .lexer import LexError, Tok, tokenize

_MAX_INCLUDE_DEPTH = 64

#: extra include search directories (the CLI's ``-I`` flag). Consulted
#: AFTER the includer-relative path — which is the reference's only
#: resolution rule (Parser.hs:244-247) and stays the primary one.
INCLUDE_PATH: list[str] = []


def _resolve_include(fname: str, file_path: str | None) -> str | None:
    """First existing candidate: includer-relative, then each -I dir."""
    candidates = [os.path.join(os.path.dirname(file_path), fname)
                  if file_path else fname]
    candidates += [os.path.join(d, fname) for d in INCLUDE_PATH]
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


class QasmParseError(Exception):
    """A parse error with megaparsec-style pretty rendering."""

    def __init__(self, pos: A.SourcePos, message: str, source_line: str = ""):
        self.pos = pos
        self.message = message
        self.source_line = source_line
        super().__init__(self.pretty())

    def pretty(self) -> str:
        gutter = " " * len(str(self.pos.line))
        out = f"{self.pos.file}:{self.pos.line}:{self.pos.col}:\n"
        if self.source_line:
            caret = " " * (self.pos.col - 1) + "^"
            out += (
                f"{gutter} |\n"
                f"{self.pos.line} | {self.source_line}\n"
                f"{gutter} | {caret}\n"
            )
        out += self.message + "\n"
        return out


@dataclass
class ParserState:
    """Parser symbol table, persisted across REPL lines (``ParserState``,
    Parser.hs:55-59)."""

    id_table: dict[str, A.SourcePos] = field(default_factory=dict)
    file_path: str | None = None

    def copy(self) -> "ParserState":
        return ParserState(dict(self.id_table), self.file_path)


def initial_state(file_path: str | None = None) -> ParserState:
    return ParserState({}, file_path)


def parse_openqasm(file_path: str, text: str) -> list[A.Stmt]:
    """Batch parse (reference ``parseOpenQASM``, Parser.hs:61-68).

    Raises :class:`QasmParseError` on failure.
    """
    ast, _ = parse_openqasm_incremental(initial_state(file_path), text)
    return ast


def parse_openqasm_incremental(state: ParserState, text: str) -> tuple[list[A.Stmt], ParserState]:
    """Incremental parse threading the symbol table (``parseOpenQASM'``).

    Returns (ast, new_state); the input state is never mutated, so a failed
    line is atomic.
    """
    with profiling.span("qubism.parse"):
        new_state = state.copy()
        file = new_state.file_path or ""
        try:
            toks = tokenize(text, file)
        except LexError as e:
            raise QasmParseError(e.pos, e.message, e.source_line) from None
        p = _Parser(toks, text.splitlines(), new_state.id_table, new_state.file_path)
        return p.program(), new_state


class _Parser:
    def __init__(self, toks: list[Tok], lines: list[str], symtab: dict, file_path: str | None, depth: int = 0):
        self.toks = toks
        self.lines = lines
        self.symtab = symtab  # shared (by reference) with including parsers
        self.file_path = file_path
        self.depth = depth
        self.i = 0

    # -- token plumbing -------------------------------------------------------

    def peek(self, ahead: int = 0) -> Tok:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Tok:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at(self, kind: str, value=None) -> bool:
        t = self.peek()
        return t.kind == kind and (value is None or t.value == value)

    def error(self, message: str, tok: Tok | None = None):
        tok = tok or self.peek()
        line = ""
        if 0 < tok.pos.line <= len(self.lines):
            line = self.lines[tok.pos.line - 1]
        raise QasmParseError(tok.pos, message, line)

    def expect_sym(self, s: str) -> Tok:
        if not self.at("sym", s):
            self.error(f"unexpected {self._describe(self.peek())}; expecting '{s}'")
        return self.next()

    @staticmethod
    def _describe(t: Tok) -> str:
        if t.kind == "eof":
            return "end of input"
        if t.kind == "sym":
            return f"'{t.value}'"
        if t.kind == "kw":
            return f"keyword '{t.value}'"
        return f"{t.kind} '{t.value}'"

    # -- identifiers (Parser.hs:140-160, 342-349) ------------------------------

    def _raw_ident(self) -> tuple[str, A.SourcePos]:
        t = self.peek()
        if t.kind == "kw":
            self.error(f"keyword {t.value} cannot be an identifier")
        if t.kind != "ident":
            self.error(f"unexpected {self._describe(t)}; expecting identifier")
        self.next()
        return t.value, t.pos

    def new_ident(self) -> str:
        name, pos = self._raw_ident()
        if name in self.symtab:
            self.error(f"Redeclaration of {name}", Tok("ident", name, pos))
        self.symtab[name] = pos
        return name

    def known_ident(self) -> str:
        name, pos = self._raw_ident()
        if name not in self.symtab:
            self.error(f"Undeclared identifier: {name}", Tok("ident", name, pos))
        return name

    def shadow_ident(self) -> str:
        name, pos = self._raw_ident()
        self.symtab[name] = pos  # unconditional insert (Parser.hs:219-222)
        return name

    def nat(self) -> int:
        t = self.peek()
        if t.kind != "nat":
            self.error(f"unexpected {self._describe(t)}; expecting natural number")
        self.next()
        return t.value

    # -- program (Parser.hs:184-189) -------------------------------------------

    def program(self) -> list[A.Stmt]:
        self._maybe_header()
        stmts: list[A.Stmt] = []
        while not self.at("eof"):
            stmts.append(self.stmt())
            if self.at("sym", ";") or self.at("sym", "}"):
                self.next()
            elif self.at("eof"):
                break
            else:
                self.error(
                    f"unexpected {self._describe(self.peek())}; expecting ';' or '}}'"
                )
        return stmts

    def _maybe_header(self):
        if self.at("ident", "OPENQASM"):
            save = self.i
            self.next()
            if self.at("real", 2.0):
                self.next()
                self.expect_sym(";")
            else:
                self.i = save  # not a header; fall through to stmt parsing

    # -- statements -----------------------------------------------------------

    def stmt(self) -> A.Stmt:
        t = self.peek()
        pos = t.pos
        if t.kind == "kw":
            if t.value == "if":
                s = self.cond()
            elif t.value in ("qreg", "creg"):
                s = self.reg_decl()
            elif t.value == "gate":
                s = self.gate_decl()
            elif t.value in ("U", "CX", "barrier"):
                s = A.UOp(self.uop())
            elif t.value in ("measure", "reset"):
                s = A.QOp(self.qop())
            elif t.value == "include":
                s = self.include()
            else:
                self.error(f"unexpected {self._describe(t)}; expecting statement")
        elif t.kind == "dump":
            self.next()
            s = A.UOp(A.Dump())
        elif t.kind == "ident":
            # 'opaque' is NOT reserved (reference parity: Parser.hs:134) —
            # treat it as the spec's opaque-gate declaration only when it
            # is not itself a declared gate and a declaration follows
            if (t.value == "opaque" and t.value not in self.symtab
                    and self.peek(1).kind == "ident"):
                s = self.opaque_decl()
            else:
                s = A.UOp(self.func_call())
        else:
            self.error(f"unexpected {self._describe(t)}; expecting statement")
        return A.PosInfo(pos, s)

    def reg_decl(self) -> A.Stmt:
        kw = self.next().value
        name = self.new_ident()
        self.expect_sym("[")
        size = self.nat()
        self.expect_sym("]")
        return A.QRegDecl(name, size) if kw == "qreg" else A.CRegDecl(name, size)

    def gate_decl(self) -> A.Stmt:
        self.next()  # 'gate'
        name = self.new_ident()
        snapshot = dict(self.symtab)  # includes the gate's own name
        params: list[str] = []
        if self.at("sym", "("):
            self.next()
            params = self._ident_list(self.shadow_ident)
            self.expect_sym(")")
        args = self._ident_list(self.shadow_ident)
        if not args:
            self.error("gate declaration requires at least one argument")
        self.expect_sym("{")
        body: list[A.UnitaryOp] = []
        while not self.at("sym", "}") and not self.at("eof"):
            body.append(self.uop_or_func())
            self.expect_sym(";")
        # the closing '}' is consumed by program() as the statement separator
        self.symtab.clear()
        self.symtab.update(snapshot)  # restore scope (Parser.hs:216)
        return A.GateDecl(name, tuple(params), tuple(args), tuple(body))

    def opaque_decl(self) -> A.Stmt:
        """``opaque name(params) qargs`` — same head grammar as a gate
        declaration, no body (spec §4.1). Param/arg names are scoped to
        the declaration like a gate's (snapshot/restore), only the gate
        name persists."""
        self.next()  # 'opaque'
        name = self.new_ident()
        snapshot = dict(self.symtab)
        params: list[str] = []
        if self.at("sym", "("):
            self.next()
            params = self._ident_list(self.shadow_ident)
            self.expect_sym(")")
        args = self._ident_list(self.shadow_ident)
        if not args:
            self.error("opaque declaration requires at least one argument")
        self.symtab.clear()
        self.symtab.update(snapshot)
        return A.OpaqueDecl(name, tuple(params), tuple(args))

    def _ident_list(self, item) -> list[str]:
        """Comma-separated, possibly empty, trailing comma tolerated
        (megaparsec ``sepEndBy``)."""
        out = []
        if not (self.at("ident") or self.at("kw")):
            return out
        out.append(item())
        while self.at("sym", ","):
            self.next()
            if not (self.at("ident") or self.at("kw")):
                break
            out.append(item())
        return out

    def include(self) -> A.Stmt:
        self.next()  # 'include'
        t = self.peek()
        if t.kind != "str":
            self.error(f"unexpected {self._describe(t)}; expecting quoted file path")
        self.next()
        if self.depth >= _MAX_INCLUDE_DEPTH:
            self.error(f"include depth exceeds {_MAX_INCLUDE_DEPTH} (include cycle?)", t)
        fname = _resolve_include(t.value, self.file_path)
        if fname is None:
            self.error(f"Cannot include: {t.value} does not exist", t)
        with open(fname) as f:
            source = f.read()
        try:
            toks = tokenize(source, fname)
        except LexError as e:
            raise QasmParseError(e.pos, e.message, e.source_line) from None
        sub = _Parser(toks, source.splitlines(), self.symtab, fname, self.depth + 1)
        return A.StmtList(tuple(sub.program()))

    def cond(self) -> A.Stmt:
        self.next()  # 'if'
        self.expect_sym("(")
        name = self.known_ident()
        self.expect_sym("==")
        value = self.nat()
        self.expect_sym(")")
        return A.Cond(name, value, self.qop())

    # -- quantum / unitary ops ---------------------------------------------------

    def qop(self) -> A.QuantumOp:
        t = self.peek()
        if t.kind == "kw" and t.value == "measure":
            self.next()
            src = self.argument()
            self.expect_sym("->")
            tgt = self.argument()
            return A.Measure(src, tgt)
        if t.kind == "kw" and t.value == "reset":
            self.next()
            return A.Reset(self.argument())
        return A.QUnitary(self.uop_or_func())

    def uop_or_func(self) -> A.UnitaryOp:
        t = self.peek()
        if t.kind == "kw" and t.value in ("U", "CX", "barrier"):
            return self.uop()
        if t.kind == "dump":
            self.next()
            return A.Dump()
        if t.kind == "ident":
            return self.func_call()
        self.error(f"unexpected {self._describe(t)}; expecting unitary operation")

    def uop(self) -> A.UnitaryOp:
        t = self.next()
        if t.value == "U":
            self.expect_sym("(")
            e1 = self.expr()
            self.expect_sym(",")
            e2 = self.expr()
            self.expect_sym(",")
            e3 = self.expr()
            self.expect_sym(")")
            return A.U(e1, e2, e3, self.argument())
        if t.value == "CX":
            a1 = self.argument()
            self.expect_sym(",")
            a2 = self.argument()
            return A.CX(a1, a2)
        if t.value == "barrier":
            return A.Barrier(tuple(self._arg_list()))
        raise AssertionError(t)

    def func_call(self) -> A.UnitaryOp:
        name = self.known_ident()
        params: list[A.Expr] = []
        if self.at("sym", "("):
            self.next()
            if not self.at("sym", ")"):
                params.append(self.expr())
                while self.at("sym", ","):
                    self.next()
                    if self.at("sym", ")"):
                        break
                    params.append(self.expr())
            self.expect_sym(")")
        return A.Func(name, tuple(params), tuple(self._arg_list()))

    def _arg_list(self) -> list[A.Arg]:
        out = []
        if not (self.at("ident") or self.at("kw")):
            return out
        out.append(self.argument())
        while self.at("sym", ","):
            self.next()
            if not (self.at("ident") or self.at("kw")):
                break
            out.append(self.argument())
        return out

    def argument(self) -> A.Arg:
        name = self.known_ident()
        if self.at("sym", "["):
            self.next()
            idx = self.nat()
            self.expect_sym("]")
            return A.ArgBit(name, idx)
        return A.ArgReg(name)

    # -- expressions (Parser.hs:314-335) ---------------------------------------

    _FUNCS = ("sin", "cos", "tan", "exp", "ln", "sqrt")

    def expr(self) -> A.Expr:
        return self._add()

    def _add(self) -> A.Expr:
        lhs = self._mul()
        while self.at("sym", "+") or self.at("sym", "-"):
            op = "add" if self.next().value == "+" else "sub"
            lhs = A.Binary(op, lhs, self._mul())
        return lhs

    def _mul(self) -> A.Expr:
        lhs = self._pow()
        while self.at("sym", "*") or self.at("sym", "/"):
            op = "mul" if self.next().value == "*" else "div"
            lhs = A.Binary(op, lhs, self._pow())
        return lhs

    def _pow(self) -> A.Expr:
        # 'pow' is a left-associative word operator (Parser.hs:330)
        lhs = self._unary()
        while self.at("ident", "pow"):
            self.next()
            lhs = A.Binary("pow", lhs, self._unary())
        return lhs

    def _unary(self) -> A.Expr:
        t = self.peek()
        if t.kind == "sym" and t.value == "-":
            self.next()
            return A.Unary("neg", self._unary())
        if t.kind == "kw" and t.value in self._FUNCS:
            self.next()
            return A.Unary(t.value, self._unary())
        return self._atom()

    def _atom(self) -> A.Expr:
        t = self.peek()
        if t.kind == "kw" and t.value == "pi":
            self.next()
            return A.Pi()
        if t.kind == "ident":
            if t.value == "pow":
                self.error("unexpected 'pow'; expecting expression")
            return A.EIdent(self.known_ident())
        if t.kind == "real":
            self.next()
            return A.Real(float(t.value))
        if t.kind == "nat":
            self.next()
            return A.Real(float(t.value))
        if t.kind == "sym" and t.value == "(":
            self.next()
            e = self.expr()
            self.expect_sym(")")
            return e
        self.error(f"unexpected {self._describe(t)}; expecting expression")
