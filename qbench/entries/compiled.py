"""The DSL user who compiles once and runs many inputs: one
``CompiledCircuit`` of the family's circuit, built at set-up; each program
writes its basis state |x> into the one state buffer, calls the circuit in
place and waits for the device."""

from __future__ import annotations

import numpy as np

from qbench.harness import Outcome


class Compiled:
    def __init__(self, ctx):
        from qubism_torch.core.gates import Prim
        from qubism_torch.ops.fusion import CompiledCircuit

        self.ctx = ctx
        prims = [Prim(np.asarray(u), tuple(t), diag) for u, t, diag in ctx.family.body(ctx.cfg)]
        self.circuit = CompiledCircuit(ctx.n, prims)
        self.state = self.circuit.init_state()

    def prepare(self, p: dict, seed: int) -> int:
        return self.ctx.family.basis(self.ctx.cfg, p)

    def program(self, x: int) -> Outcome:
        self.state.zero_()
        self.state[x] = 1
        self.circuit(self.state)
        fp = self.state.index_select(0, self.ctx.idx)
        self.ctx.sync()
        return Outcome(0, None, fp)

    def answer(self):
        return self.state

    def release(self):
        self.circuit = self.state = None


def make(ctx):
    return Compiled(ctx)
