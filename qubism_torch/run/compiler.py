"""Whole-program compiler: QASM AST -> event stream -> fused segments.

Counterpart of qubism_tpu/run/compiler.py, the CLI's ``--compile`` path
(:meth:`CompiledProgram.run`) and ``--mesh`` path
(:meth:`CompiledProgram.run_sharded`).
The interpreter (:mod:`qubism_torch.run.interpreter`) is the semantics
reference; this module statically elaborates the program (user gates
expanded, parameters bound, register views resolved to absolute qubits)
into a flat event stream, and runs every measurement-free run of unitaries
as one :class:`~qubism_torch.ops.fusion.CompiledCircuit`, planned once.

All quantum registers sit in one state vector, in declaration order, named
``"(x)".join(registers)``: whole-program fusion at the cost of the
interpreter's lazy register fusion. Measurement, reset and creg-conditional
ops are host boundaries, as in the interpreter; adjacent measure
statements coalesce into one event (one marginal-table sweep).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.creg import CReg
from ..core.gates import Prim, is_diagonal, u3_matrix
from ..core.statevec import StateVec
from ..ops import apply as _apply
from ..ops import measure as _measure
from ..ops.fusion import DEFAULT_MAX_BLOCK, CompiledCircuit
from ..qasm import ast as A
from .interpreter import Interpreter
from .progstate import ProgState, QRegView, blank_state

# -- event IR -----------------------------------------------------------------


@dataclass(frozen=True)
class EvGates:
    prims: tuple[Prim, ...]


@dataclass(frozen=True)
class EvMeasure:
    """One measurement event: the qubits of one or more adjacent measure
    statements, measured in order in one marginal-table sweep.

    ``writes``: per statement, (creg, bit index or None, count): ``count``
    outcomes are consumed in order; bit index None writes the whole
    register."""

    qubits: tuple[int, ...]        # absolute qubit indices, in order
    writes: tuple[tuple[str, int | None, int], ...]


@dataclass(frozen=True)
class EvReset:
    qubits: tuple[int, ...]


@dataclass(frozen=True)
class EvCond:
    creg: str
    value: int
    body: tuple


@dataclass(frozen=True)
class EvDump:
    pass


class _Elaborator(Interpreter):
    """Static elaborator: the interpreter's dispatch and binding, recording
    prims and events instead of touching a state."""

    def __init__(self, ps: ProgState):
        super().__init__(ps)
        self.layout: dict[str, int] = {}  # qreg name -> first absolute qubit
        self.n = 0
        self.events: list = []
        self._sink: list | None = None  # redirection for Cond bodies

    def _emit(self, ev):
        target = self._sink if self._sink is not None else self.events
        if isinstance(ev, EvGates) and target and isinstance(target[-1], EvGates):
            target[-1] = EvGates(target[-1].prims + ev.prims)
        elif isinstance(ev, EvMeasure) and target and isinstance(target[-1], EvMeasure):
            prev = target[-1]
            target[-1] = EvMeasure(prev.qubits + ev.qubits, prev.writes + ev.writes)
        else:
            target.append(ev)

    def _abs_qubits(self, arg: A.Arg) -> list[int]:
        ps = self.ps
        view = ps.find(arg.name, ps.qregs)
        base = self.layout[arg.name]
        if isinstance(arg, A.ArgBit):
            self._check_index(arg, view.size)
            return [base + arg.index]
        return [base + k for k in range(view.size)]

    def run_stmt(self, stmt: A.Stmt):
        if isinstance(stmt, A.PosInfo):
            self.ps.pos = stmt.pos
            self.run_stmt(stmt.stmt)
        elif isinstance(stmt, A.QRegDecl):
            # register bookkeeping without a state: the compiled program
            # owns one flat layout
            ps = self.ps
            ps.check_name_conflict(stmt.name, ps.qregs)
            ps.check_name_conflict(stmt.name, ps.stvecs)
            ps.qregs[stmt.name] = QRegView(stmt.name, 0, stmt.size)
            ps.stvecs[stmt.name] = None
            self.layout[stmt.name] = self.n
            self.n += stmt.size
        elif isinstance(stmt, A.Cond):
            # creg values are run-time data: record a conditional event
            self.ps.find(stmt.creg, self.ps.cregs)  # existence check
            prev, self._sink = self._sink, []
            try:
                self.run_qop(stmt.op)
            finally:
                body, self._sink = self._sink, prev
            self._emit(EvCond(stmt.creg, stmt.value, tuple(body)))
        else:
            super().run_stmt(stmt)

    def run_qop(self, op: A.QuantumOp):
        if isinstance(op, A.Measure):
            src, tgt = op.source, op.target
            qubits = tuple(self._abs_qubits(src))
            ps = self.ps
            cr = ps.find(tgt.name, ps.cregs)
            if isinstance(tgt, A.ArgBit):
                if not tgt.index < cr.size:
                    ps.runtime_error(f"Index out of bounds when writing to {tgt.name}")
                self._emit(EvMeasure(qubits, ((tgt.name, tgt.index, len(qubits)),)))
            else:
                if len(qubits) != cr.size:
                    ps.runtime_error(f"Mismatched size on overwrite of {tgt.name}")
                self._emit(EvMeasure(qubits, ((tgt.name, None, len(qubits)),)))
        elif isinstance(op, A.Reset):
            self._emit(EvReset(tuple(self._abs_qubits(op.arg))))
        else:
            super().run_qop(op)

    def run_uop(self, op: A.UnitaryOp):
        if isinstance(op, A.U):
            u = u3_matrix(self.eval_expr(op.theta), self.eval_expr(op.phi),
                          self.eval_expr(op.lam))
            diag = is_diagonal(u)
            table = np.diag(u).copy() if diag else u
            self._emit(EvGates(tuple(Prim(table, (q,), diag)
                                     for q in self._abs_qubits(op.arg))))
        elif isinstance(op, A.CX):
            self.cx(op.control, op.target)
        elif isinstance(op, A.Dump):
            self._emit(EvDump())
        else:
            super().run_uop(op)  # Func expansion / Barrier

    def _apply_2q(self, u, qr1, i, qr2, j):
        q1 = self.layout[qr1] + i
        q2 = self.layout[qr2] + j
        if q1 == q2:
            self.ps.runtime_error(f"CX with identical control and target qubit: {qr1}[{i}]")
        self._emit(EvGates((Prim(u, (q1, q2)),)))


def elaborate(ast):
    """Statically elaborate a program to its flat event stream. Returns
    (n, events, cregs0, layout, qreg_sizes)."""
    ps = blank_state(0)
    elab = _Elaborator(ps)
    for stmt in ast:
        elab.run_stmt(stmt)
    qreg_sizes = {name: ps.qregs[name].size for name in ps.qregs}
    return elab.n, list(elab.events), dict(ps.cregs), dict(elab.layout), qreg_sizes


class CompiledProgram:
    """A QASM program lowered to fused segments plus host control flow."""

    def __init__(self, ast, max_block: int = DEFAULT_MAX_BLOCK):
        (self.n, self.events, self.cregs0, self.layout,
         self.qreg_sizes) = elaborate(ast)
        self.max_block = max_block
        self._segments: dict[int, CompiledCircuit] = {}

    @property
    def name(self) -> str:
        """The one state vector's name: its registers in declaration order."""
        return "(x)".join(self.layout)

    def _segment(self, ev: EvGates) -> CompiledCircuit:
        key = id(ev)
        if key not in self._segments:
            from ..utils.profiling import vlog

            circ = CompiledCircuit(self.n, ev.prims, self.max_block, scheduled=True)
            vlog(f"segment: {circ.stats()}")
            self._segments[key] = circ
        return self._segments[key]

    def run(self, seed: int | None = None, dump_writer=None):
        """Execute from |0...0>. Returns (state, cregs dict, generator): the
        state is one complex64 tensor (None for a program with no qubits),
        the generator the CPU ``torch.Generator`` seeded from ``seed`` that
        drew the measurements."""
        dump_writer = dump_writer or (lambda s: None)
        gen = torch.Generator().manual_seed(0 if seed is None else seed)
        state = _apply.zero_state(self.n) if self.n else None
        cregs = dict(self.cregs0)

        def exec_events(events):
            for ev in events:
                if isinstance(ev, EvGates):
                    self._segment(ev)(state)
                elif isinstance(ev, EvMeasure):
                    bits = _measure.measure_qubits(state, gen, ev.qubits, self.n)
                    off = 0
                    for creg, bit_index, count in ev.writes:
                        if bit_index is None:
                            cregs[creg] = CReg.of(bits[off:off + count])
                        else:
                            cregs[creg] = cregs[creg].set_bit(bit_index, bits[off])
                        off += count
                elif isinstance(ev, EvReset):
                    for q in ev.qubits:
                        _measure.collapse(state, 0, q, self.n)
                elif isinstance(ev, EvCond):
                    if cregs[ev.creg].to_natural() == ev.value:
                        exec_events(ev.body)
                elif isinstance(ev, EvDump):
                    dump_writer(self._pretty(state, cregs))

        exec_events(self.events)
        # the recursive closure is a reference cycle that holds the state:
        # break it, so that the state's memory is freed when the caller drops
        # it, not at the next garbage collection
        exec_events = None
        return state, cregs, gen

    def mesh_devices(self, mesh=None):
        """The devices of a mesh run: ``mesh`` as given when it is a device
        sequence, else :func:`~qubism_torch.parallel.make_mesh` of that
        many shards (all GPUs for None), cut to at most 2^(n-2) shards so
        that every shard keeps the 2 local qubits a 2-qubit gate needs.
        Raises ValueError when the machine has too few GPUs."""
        from ..parallel import make_mesh

        if mesh is not None and not isinstance(mesh, int):
            return tuple(mesh)
        limit = 1 << max(self.n - 2, 0)
        devices = make_mesh(None if mesh is None else min(mesh, limit))
        return devices if len(devices) <= limit else make_mesh(limit)

    def run_sharded(self, mesh=None, seed: int | None = None, dump_writer=None,
                    banks: int | None = None):
        """Execute from |0...0> over a mesh of devices
        (:meth:`mesh_devices`) through :class:`~qubism_torch.parallel.ShardedSim`,
        with 2^``banks`` banks per shard (default ``default_banks``).
        Returns (sim, cregs dict, generator); sim is None for a program with
        no qubits."""
        from ..parallel import ShardedSim

        devices = self.mesh_devices(mesh)
        dump_writer = dump_writer or (lambda s: None)
        gen = torch.Generator().manual_seed(0 if seed is None else seed)
        sim = ShardedSim(self.n, devices, banks=banks) if self.n else None
        cregs = dict(self.cregs0)

        def exec_events(events):
            for ev in events:
                if isinstance(ev, EvGates):
                    sim.apply(ev.prims)
                elif isinstance(ev, EvMeasure):
                    bits = sim.measure_qubits(ev.qubits, gen)
                    off = 0
                    for creg, bit_index, count in ev.writes:
                        if bit_index is None:
                            cregs[creg] = CReg.of(bits[off:off + count])
                        else:
                            cregs[creg] = cregs[creg].set_bit(bit_index, bits[off])
                        off += count
                elif isinstance(ev, EvReset):
                    for q in ev.qubits:
                        sim.collapse(q, 0)
                elif isinstance(ev, EvCond):
                    if cregs[ev.creg].to_natural() == ev.value:
                        exec_events(ev.body)
                elif isinstance(ev, EvDump):
                    dump_writer(self._pretty_for(self.sim_state(sim), cregs))

        exec_events(self.events)
        exec_events = None  # as in run(): no cycle may hold the banks
        return sim, cregs, gen

    def sim_state(self, sim) -> StateVec | None:
        """A mesh run's state gathered into one host StateVec (for dumps;
        small n only)."""
        if sim is None:
            return None
        amps = sim.amplitudes().astype(np.complex64)
        return StateVec(self.n, torch.from_numpy(amps))

    def prog_state(self, state, cregs, gen) -> ProgState:
        """The result of :meth:`run` as an interpreter ProgState: one state
        vector named :attr:`name` holding every register."""
        ps = ProgState(cregs=dict(cregs), gen=gen)
        if state is not None:
            ps.stvecs[self.name] = StateVec(self.n, state)
        for reg, base in self.layout.items():
            ps.qregs[reg] = QRegView(self.name, base, self.qreg_sizes[reg])
        return ps

    def _pretty_for(self, sv, cregs) -> str:
        name = self.name
        out = ["Dump of the internal state: \n\n"]
        if sv is not None:
            out.append(f"State Vector {name}:\n{sv}")
        out.append("\n")
        for reg, base in sorted(self.layout.items()):
            out.append(
                f"QReg {reg}[{self.qreg_sizes[reg]}] -- targets state vector "
                f'"{name}" starting at qubit {base}\n'
            )
        out.append("\n")
        for cname in sorted(cregs):
            out.append(f"CReg {cname}[{cregs[cname].size}] = {cregs[cname]}\n")
        return "".join(out)

    def _pretty(self, state, cregs) -> str:
        return self._pretty_for(None if state is None else StateVec(self.n, state), cregs)
