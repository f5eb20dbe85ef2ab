"""The exact density backend through the file path:
``qubism_torch.cli.eval_file`` with ``backend="density"`` and the
configuration's ``noise``, as ``python -m qubism_torch <file> --backend
density --noise <spec> --seed s --shots k`` runs it. The program's state is
its vectorized rho: 2^num_qubits amplitudes, the row index in the top
half of the bits."""

from __future__ import annotations

import io

from qbench.filepath import FileEntry
from qbench.harness import Outcome


class DensityEntry(FileEntry):
    def __init__(self, ctx):
        super().__init__(ctx, compile_mode=False)
        self.noise = ctx.cfg["noise"]

    def program(self, inputs) -> Outcome:
        from qubism_torch.cli import eval_file

        text, seed = inputs
        self._last = None  # the previous answer's memory is free for this program
        box = {}

        def inspect(result):
            rho, _ = result
            if rho is not None and rho.state.numel() == 1 << self.ctx.n:
                box["state"] = rho.state
                box["fp"] = rho.state.index_select(0, self.ctx.idx)

        out = io.StringIO()
        rc = eval_file(self.path, source=text, seed=seed, shots=self.shots, out=out,
                       inspect=inspect, backend="density", noise=self.noise)
        self._last = box.get("state")
        return Outcome(rc, out.getvalue(), box.get("fp"))


def make(ctx):
    return DensityEntry(ctx)
