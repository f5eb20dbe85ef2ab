"""The OpenQASM interpreter: AST → engine ops.

Counterpart of reference src/Qubism/QASM/Simulation.hs. Host Python drives
statement dispatch (mid-circuit measurement and creg conditionals are host
control flow by nature); runs of unitary statements are queued and applied
as fused kernel passes (:mod:`qubism_torch.ops.fusion`).

Semantics carried over exactly (Simulation.hs:55-227): lazy register fusion
before any 2-qubit op; measurement of a register is sequential per-qubit in
index order; reset is projection to |0> without Born sampling; CX broadcasts
over all four bit/register argument shapes (equal sizes required for
reg-reg); user gates are re-expanded at every call with param/arg
substitution; ``if (c == n)`` compares the LSB-first creg value.

Deliberate deviations (see config module docs): correct Born rule and
spec-correct U by default; single-qubit gates on fused registers are NOT
dropped (reference bug, Simulation.hs:100); reset of a fused register resets
all of its qubits (the reference's fold over [start..size-1] misses shifted
views, Simulation.hs:152-155).
"""

from __future__ import annotations

import math

import numpy as np

from ..config import config
from ..core.creg import CReg
from ..core.gates import Prim, is_diagonal, u3_matrix
from ..ops import measure as _measure
from ..qasm import ast as A
from ..utils import profiling
from .progstate import CustomGate, ProgState, blank_state

_CNOT = np.array(
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=np.complex128
)


def run_program(ast, seed: int | None = None) -> ProgState:
    """Run a program from a blank state (reference ``runProgram``,
    Simulation.hs:42-45). Raises :class:`QasmRuntimeError` on failure."""
    return run_program_incremental(ast, blank_state(seed))


def run_program_incremental(ast, ps: ProgState) -> ProgState:
    """Run a program resuming from ``ps`` (reference ``runProgram'``,
    Simulation.hs:47-53). ``ps`` is never mutated: on success a new state is
    returned, on error the exception propagates and the caller's state is
    intact — the REPL's atomic-line contract. The kernels update states in
    place, so the new state starts from ``ps.copy()``'s clones of the
    caller's tensors (a run from a blank state clones nothing)."""
    with profiling.span("qubism.interp"):
        new = ps.copy()
        interp = Interpreter(new)
        for stmt in ast:
            interp.run_stmt(stmt)
        interp.flush()  # materialize any trailing unitary run
        return new


class Interpreter:
    """Statement dispatcher with a LAZY GATE QUEUE: unitary statements
    enqueue primitives per backing state vector and whole
    measurement-free runs flush as fused kernel passes
    (ops.fusion.apply_prims_fused). Observable semantics are untouched —
    every observation point (measure, reset, :dump, register fusion,
    end of program/REPL line) flushes first."""

    def __init__(self, ps: ProgState, dump_writer=None):
        self.ps = ps
        self.dump_writer = dump_writer or (lambda s: print(s, end=""))
        self._queue: dict[str, list] = {}  # backing statevec id -> [Prim]

    # -- lazy gate queue --------------------------------------------------------

    def _enqueue(self, target: str, prim):
        self._queue.setdefault(target, []).append(prim)

    def _flush(self, target: str | None = None):
        """Apply pending prims for ``target`` (or all) as fused chunks."""
        from ..ops.fusion import apply_prims_fused

        ps = self.ps
        for t in ([target] if target is not None else list(self._queue)):
            prims = self._queue.pop(t, None)
            if not prims:
                continue
            sv = ps.stvecs[t]
            with profiling.span("qubism.flush"):
                apply_prims_fused(sv.state, prims, sv.n)

    def flush(self):
        """Materialize all pending gates (end of program / REPL line)."""
        self._flush()

    # -- statement dispatch (Simulation.hs:55-76) --------------------------------

    def run_stmt(self, stmt: A.Stmt):
        ps = self.ps
        if isinstance(stmt, A.PosInfo):
            ps.pos = stmt.pos
            self.run_stmt(stmt.stmt)
        elif isinstance(stmt, A.StmtList):
            for s in stmt.stmts:
                self.run_stmt(s)
        elif isinstance(stmt, A.QRegDecl):
            ps.add_qreg(stmt.name, stmt.size)
        elif isinstance(stmt, A.CRegDecl):
            ps.add_creg(stmt.name, stmt.size)
        elif isinstance(stmt, A.GateDecl):
            ps.add_func(CustomGate(stmt.params, stmt.args, stmt.body), stmt.name)
        elif isinstance(stmt, A.OpaqueDecl):
            # declared with no body (spec §4.1): registering makes later
            # calls resolve; body=None makes applying one a runtime error
            ps.add_func(CustomGate(stmt.params, stmt.args, None), stmt.name)
        elif isinstance(stmt, A.QOp):
            self.run_qop(stmt.op)
        elif isinstance(stmt, A.UOp):
            self.run_uop(stmt.op)
        elif isinstance(stmt, A.Cond):
            cr = ps.find(stmt.creg, ps.cregs)
            if cr.to_natural() == stmt.value:
                self.run_qop(stmt.op)
        else:  # pragma: no cover
            raise AssertionError(f"unknown statement {stmt!r}")

    def run_qop(self, op: A.QuantumOp):
        if isinstance(op, A.QUnitary):
            self.run_uop(op.op)
        elif isinstance(op, A.Measure):
            self.observe(op.source, op.target)
        elif isinstance(op, A.Reset):
            self.reset(op.arg)
        else:  # pragma: no cover
            raise AssertionError(op)

    def run_uop(self, op: A.UnitaryOp):
        if isinstance(op, A.U):
            u = u3_matrix(self.eval_expr(op.theta), self.eval_expr(op.phi), self.eval_expr(op.lam))
            self.apply_1q(u, op.arg)
        elif isinstance(op, A.CX):
            self.cx(op.control, op.target)
        elif isinstance(op, A.Func):
            self.custom_op(op.name, [self.eval_expr(e) for e in op.params], op.args)
        elif isinstance(op, A.Barrier):
            pass  # scheduling hint only (Simulation.hs:71)
        elif isinstance(op, A.Dump):
            self.flush()
            self.dump_writer(self.ps.pretty())
        else:  # pragma: no cover
            raise AssertionError(op)

    # -- gate application (Simulation.hs:79-122) -----------------------------------

    def apply_1q(self, u: np.ndarray, arg: A.Arg):
        """Apply a 1-qubit gate to a bit or, broadcast, to a whole register
        (reference ``##>``, Simulation.hs:79-85)."""
        ps = self.ps
        view = ps.find(arg.name, ps.qregs)
        sv = ps.find(view.target, ps.stvecs)
        diag = is_diagonal(u)
        table = np.diag(u).copy() if diag else u
        if isinstance(arg, A.ArgBit):
            self._check_index(arg, view.size)
            qubits = [view.start + arg.index]
        else:
            qubits = [view.start + k for k in range(view.size)]
        # enqueue on the BACKING state vector (the reference writes under
        # the QReg's name here, orphaning the update after fusion — bug)
        for q in qubits:
            self._enqueue(view.target, Prim(table, (q,), diag))

    def _check_index(self, arg: A.ArgBit, size: int):
        if not (0 <= arg.index < size):
            self.ps.runtime_error(
                f"Index {arg.index} out of bounds for {arg.name}[{size}]"
            )

    def _apply_2q(self, u: np.ndarray, qr1: str, i: int, qr2: str, j: int):
        """Fuse-then-apply for potentially entangling 2-qubit ops
        (reference ``withIndex2``, Simulation.hs:102-122)."""
        ps = self.ps
        t1 = ps.find(qr1, ps.qregs).target
        t2 = ps.find(qr2, ps.qregs).target
        if t1 != t2:
            # register fusion tensors the backing vectors: materialize
            # both queues first
            self._flush(t1)
            self._flush(t2)
        target = ps.fuse_qregs(qr1, qr2)
        sv = ps.find(target, ps.stvecs)
        q1 = ps.find(qr1, ps.qregs).start + i
        q2 = ps.find(qr2, ps.qregs).start + j
        if q1 == q2:
            ps.runtime_error(f"CX with identical control and target qubit: {qr1}[{i}]")
        self._enqueue(target, Prim(u, (q1, q2)))

    def cx(self, arg1: A.Arg, arg2: A.Arg):
        """CX over all four argument-shape combos (Simulation.hs:158-173)."""
        ps = self.ps
        if isinstance(arg1, A.ArgBit):
            self._check_index(arg1, ps.find_qr_size(arg1.name))
        if isinstance(arg2, A.ArgBit):
            self._check_index(arg2, ps.find_qr_size(arg2.name))
        if isinstance(arg1, A.ArgBit) and isinstance(arg2, A.ArgBit):
            self._apply_2q(_CNOT, arg1.name, arg1.index, arg2.name, arg2.index)
        elif isinstance(arg1, A.ArgBit):
            for j in range(ps.find_qr_size(arg2.name)):
                self._apply_2q(_CNOT, arg1.name, arg1.index, arg2.name, j)
        elif isinstance(arg2, A.ArgBit):
            for i in range(ps.find_qr_size(arg1.name)):
                self._apply_2q(_CNOT, arg1.name, i, arg2.name, arg2.index)
        else:
            s1 = ps.find_qr_size(arg1.name)
            s2 = ps.find_qr_size(arg2.name)
            if s1 != s2:
                ps.runtime_error(
                    f"QRegs of different sizes supplied to CX: {arg1.name} {arg2.name}"
                )
            for i in range(s1):
                self._apply_2q(_CNOT, arg1.name, i, arg2.name, i)

    # -- measurement (Simulation.hs:124-144) ------------------------------------------

    def _measure_one(self, qreg: str, k: int) -> int:
        ps = self.ps
        view = ps.find(qreg, ps.qregs)
        self._flush(view.target)
        sv = ps.find(view.target, ps.stvecs)
        return sv.measure_qubit(view.start + k, ps.gen)

    def observe(self, arg_q: A.Arg, arg_c: A.Arg):
        ps = self.ps
        if isinstance(arg_q, A.ArgBit):
            self._check_index(arg_q, ps.find_qr_size(arg_q.name))
            bits = CReg.of([self._measure_one(arg_q.name, arg_q.index)])
        else:
            # whole register: sequential semantics through marginal tables
            view = ps.find(arg_q.name, ps.qregs)
            self._flush(view.target)
            sv = ps.find(view.target, ps.stvecs)
            qubits = tuple(view.start + k for k in range(view.size))
            outs = _measure.measure_qubits(sv.state, ps.gen, qubits, sv.n)
            bits = CReg.of(outs)
        if isinstance(arg_c, A.ArgBit):
            ps.write_bit(bits[0], arg_c.name, arg_c.index)
        else:
            ps.write_creg(bits, arg_c.name)

    def reset(self, arg: A.Arg):
        """Projection to |0> without Born sampling (Simulation.hs:146-156)."""
        ps = self.ps
        view = ps.find(arg.name, ps.qregs)
        self._flush(view.target)
        sv = ps.find(view.target, ps.stvecs)
        if isinstance(arg, A.ArgBit):
            self._check_index(arg, view.size)
            qubits = [view.start + arg.index]
        else:
            qubits = [view.start + k for k in range(view.size)]
        for q in qubits:
            _measure.collapse(sv.state, 0, q, sv.n)

    # -- user gates (Simulation.hs:175-207) ----------------------------------------------

    def custom_op(self, name: str, params: list[float], args):
        ps = self.ps
        cg: CustomGate = ps.find(name, ps.funcs)
        if cg.body is None:
            ps.runtime_error(
                f"opaque gate {name} has no definition; a simulator "
                f"cannot apply it")
        param_binds = dict(zip(cg.params, params))
        arg_binds = dict(zip(cg.args, args))
        bound = [self._bind(param_binds, arg_binds, op) for op in cg.body]
        for op in bound:
            self.run_uop(op)

    def _bind(self, etable, atable, op: A.UnitaryOp) -> A.UnitaryOp:
        bind_e = lambda e: self._bind_expr(etable, e)  # noqa: E731
        bind_a = lambda a: self._bind_arg(atable, a)  # noqa: E731
        if isinstance(op, A.U):
            return A.U(bind_e(op.theta), bind_e(op.phi), bind_e(op.lam), bind_a(op.arg))
        if isinstance(op, A.CX):
            return A.CX(bind_a(op.control), bind_a(op.target))
        if isinstance(op, A.Barrier):
            return A.Barrier(tuple(bind_a(a) for a in op.args))
        if isinstance(op, A.Func):
            return A.Func(op.name, tuple(bind_e(e) for e in op.params),
                          tuple(bind_a(a) for a in op.args))
        if isinstance(op, A.Dump):
            return op
        raise AssertionError(op)  # pragma: no cover

    def _bind_expr(self, etable, e: A.Expr) -> A.Expr:
        if isinstance(e, A.Binary):
            return A.Binary(e.op, self._bind_expr(etable, e.lhs), self._bind_expr(etable, e.rhs))
        if isinstance(e, A.Unary):
            return A.Unary(e.op, self._bind_expr(etable, e.arg))
        if isinstance(e, A.EIdent):
            if e.name in etable:
                return A.Real(etable[e.name])
            self.ps.runtime_error(f"Could not bind {e.name}")
        return e

    def _bind_arg(self, atable, a: A.Arg) -> A.Arg:
        if isinstance(a, A.ArgBit):
            # formals in a gate body are bare names; indexing them is illegal
            self.ps.runtime_error("Attempted to bind an ArgBit")
        if a.name in atable:
            return atable[a.name]
        self.ps.runtime_error(f"Could not bind {a.name}")

    # -- expressions (Simulation.hs:209-227) -----------------------------------------------

    def eval_expr(self, e: A.Expr) -> float:
        if isinstance(e, A.Pi):
            return config.pi
        if isinstance(e, A.Real):
            return e.value
        if isinstance(e, A.EIdent):
            # post-binding there should be no identifiers left; the reference
            # crashes (undefined) here — we raise a proper runtime error
            self.ps.runtime_error(f"Cannot evaluate unbound identifier: {e.name}")
        if isinstance(e, A.Binary):
            a, b = self.eval_expr(e.lhs), self.eval_expr(e.rhs)
            return {
                "add": lambda: a + b, "sub": lambda: a - b, "mul": lambda: a * b,
                "div": lambda: a / b, "pow": lambda: a ** b,
            }[e.op]()
        if isinstance(e, A.Unary):
            a = self.eval_expr(e.arg)
            return {
                "neg": lambda: -a, "sin": lambda: math.sin(a),
                "cos": lambda: math.cos(a), "tan": lambda: math.tan(a),
                "exp": lambda: math.exp(a), "ln": lambda: math.log(a),
                "sqrt": lambda: math.sqrt(a),
            }[e.op]()
        raise AssertionError(e)  # pragma: no cover
