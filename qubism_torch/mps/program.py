"""Run whole OpenQASM programs on the MPS backend.

Counterpart of qubism_tpu/mps/program.py, with the contract of
:mod:`qubism_torch.stabilizer.program`: the compiler's static elaborator
(run/compiler.py:elaborate) flattens the AST to an event stream; gates
apply through :class:`MPSSim` (SWAP-routed 2q prims, truncating SVD at the
orthogonality center), and measurement, reset and feed-forward follow the
reference's host control flow (Simulation.hs:55-76). Prims wider than 2
qubits raise :class:`~qubism_torch.mps.engine.NotAdjacentError` with a
decomposition hint; qelib1-defined gates (ccx etc.) already elaborate to
1q/2q prims.
"""

from __future__ import annotations

import torch

from ..core.creg import CReg
from .engine import MPSSim


class MPSProgram:
    """A QASM program executed on the matrix-product-state engine."""

    def __init__(self, ast, chi: int = 32, trunc_budget: float | None = None,
                 max_chi: int = 256):
        from ..run.compiler import elaborate

        (self.n, self.events, self.cregs0, self.layout,
         self.qreg_sizes) = elaborate(ast)
        self.chi = chi
        self.trunc_budget = trunc_budget
        self.max_chi = max_chi

    def run(self, seed: int | None = None, dump_writer=None):
        """Execute; returns (sim, cregs). ``sim`` is the MPSSim (None for a
        program with no qregs)."""
        from ..run.compiler import EvCond, EvDump, EvGates, EvMeasure, EvReset

        dump_writer = dump_writer or (lambda s: None)
        gen = torch.Generator().manual_seed(0 if seed is None else seed)
        sim = MPSSim(self.n, chi=self.chi, gen=gen, trunc_budget=self.trunc_budget,
                     max_chi=self.max_chi) if self.n else None
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
        out = ["Dump of the internal state (mps backend): \n\n"]
        if sim is not None:
            name = "(x)".join(self.layout) if self.layout else ""
            out.append(f"MPS of {name}: {sim.n} sites, chi={sim.chi}, "
                       f"norm={sim.norm():.6f}, "
                       f"trunc_error={sim.trunc_error:.3e}\n")
            if sim.n > 1:
                ents = ", ".join(
                    f"{sim.entanglement_entropy(b):.4f}"
                    for b in range(min(sim.n - 1, 8)))
                more = " ..." if sim.n - 1 > 8 else ""
                out.append(f"bond entropies (nats): {ents}{more}\n")
            for reg, base in sorted(self.layout.items()):
                out.append(
                    f"QReg {reg}[{self.qreg_sizes[reg]}] -- qubits "
                    f"{base}..{base + self.qreg_sizes[reg] - 1}\n")
        out.append("\n")
        for cname in sorted(cregs):
            out.append(f"CReg {cname}[{cregs[cname].size}] = {cregs[cname]}\n")
        return "".join(out)
