"""A program through the file path: ``qubism_torch.cli.eval_file`` on the
program's OpenQASM text with the cell's shots, as ``python -m qubism_torch
<file> --seed s --shots k`` runs it, by the interpreter or, with
``compile_mode``, by ``CompiledProgram`` (``--compile``)."""

from __future__ import annotations

import io

from .harness import Outcome


class FileEntry:
    def __init__(self, ctx, compile_mode: bool):
        self.ctx = ctx
        self.compile_mode = compile_mode
        self.shots = ctx.traffic.get("shots")
        self.fuse_width = ctx.traffic.get("fuse_width", 5)
        # parsed as a file of this folder, so its include finds qbench/qelib1.inc
        self.path = str(ctx.root / "qbench" / "program.qasm")
        self._last = None

    def prepare(self, p: dict, seed: int):
        return self.ctx.family.text(self.ctx.cfg, p), seed

    def program(self, inputs) -> Outcome:
        from qubism_torch.cli import eval_file

        text, seed = inputs
        self._last = None  # the previous answer's memory is free for this program
        box = {}

        def inspect(ps):
            states = list(ps.stvecs.values())
            if len(states) == 1 and states[0].n == self.ctx.n:
                box["state"] = states[0].state
                box["fp"] = states[0].state.index_select(0, self.ctx.idx)

        out = io.StringIO()
        rc = eval_file(self.path, source=text, seed=seed, shots=self.shots, out=out,
                       inspect=inspect, compile_mode=self.compile_mode,
                       fuse_width=self.fuse_width)
        self._last = box.get("state")
        return Outcome(rc, out.getvalue(), box.get("fp"))

    def answer(self):
        """The last program's final state."""
        return self._last

    def release(self):
        self._last = None
