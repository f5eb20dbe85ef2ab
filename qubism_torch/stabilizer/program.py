"""Run whole OpenQASM programs on the stabilizer backend.

Counterpart of qubism_tpu/stabilizer/program.py: the compiler's static
elaborator (run/compiler.py:elaborate) turns the program into an event
stream, executed on a :class:`~qubism_torch.stabilizer.tableau.StabilizerSim`
with the state-vector executors' host control flow (reference
Simulation.hs:55-76). A non-Clifford gate raises
:class:`~qubism_torch.stabilizer.tableau.NotCliffordError` when its event
runs.
"""

from __future__ import annotations

from ..core.creg import CReg
from .tableau import StabilizerSim, stabilizer_strings


class StabilizerProgram:
    """A QASM program executed on the tableau engine."""

    def __init__(self, ast):
        from ..run.compiler import elaborate

        (self.n, self.events, self.cregs0, self.layout,
         self.qreg_sizes) = elaborate(ast)

    def run(self, seed: int | None = None, dump_writer=None):
        """Execute; returns (sim, cregs). ``sim`` is the StabilizerSim
        (None for a program with no qregs)."""
        from ..run.compiler import EvCond, EvDump, EvGates, EvMeasure, EvReset

        dump_writer = dump_writer or (lambda s: None)
        sim = StabilizerSim(self.n, seed=seed) if self.n else None
        cregs = dict(self.cregs0)

        def exec_events(events):
            for ev in events:
                if isinstance(ev, EvGates):
                    sim.apply(ev.prims)
                elif isinstance(ev, EvMeasure):
                    bits = sim.measure_qubits(ev.qubits)
                    off = 0
                    for creg, bit_index, count in ev.writes:
                        if bit_index is None:
                            cregs[creg] = CReg.of(bits[off:off + count])
                        else:
                            cregs[creg] = cregs[creg].set_bit(bit_index, bits[off])
                        off += count
                elif isinstance(ev, EvReset):
                    for q in ev.qubits:
                        sim.reset(q)
                elif isinstance(ev, EvCond):
                    if cregs[ev.creg].to_natural() == ev.value:
                        exec_events(ev.body)
                elif isinstance(ev, EvDump):
                    dump_writer(self._pretty(sim, cregs))

        exec_events(self.events)
        exec_events = None  # break the closure's cycle: sim is freed with the caller's
        return sim, cregs

    def _pretty(self, sim, cregs) -> str:
        out = ["Dump of the internal state (stabilizer backend): \n\n"]
        if sim is not None:
            name = "(x)".join(self.layout) if self.layout else ""
            out.append(f"Stabilizers of {name}:\n")
            for row in stabilizer_strings(sim.tab, sim.n):
                out.append(f"  {row}\n")
            for reg, base in sorted(self.layout.items()):
                out.append(
                    f"QReg {reg}[{self.qreg_sizes[reg]}] -- qubits "
                    f"{base}..{base + self.qreg_sizes[reg] - 1}\n")
        out.append("\n")
        for cname in sorted(cregs):
            out.append(f"CReg {cname}[{cregs[cname].size}] = {cregs[cname]}\n")
        return "".join(out)
