"""The control of the check: the plain reference in the program's place.

Each program is :func:`qbench.reference.simulate` of the program's gate
list with every product's inputs rounded to TF32 (``tf32``), one precision
below the float32 the configuration states; where the cell takes shots,
they are drawn from that state by a float64 inverse CDF and printed as the
CLI prints its counts. With ``flip_shots`` the state is the float32
reference's and each shot's first qubit is flipped where it is drawn: the
fault that the shots' number has to catch. ``python3 -m qbench.control``
runs these through the harness; the benchmark's own runs never do.
"""

from __future__ import annotations

import numpy as np

from qbench.harness import Outcome


class Control:
    def __init__(self, ctx, tf32: bool = True, flip_shots: bool = False):
        self.ctx = ctx
        self.tf32, self.flip = tf32, flip_shots
        self.shots = ctx.traffic.get("shots")
        self._last = None

    def prepare(self, p: dict, seed: int):
        return p, seed

    def program(self, inputs) -> Outcome:
        from qbench.reference import simulate

        p, seed = inputs
        ctx = self.ctx
        self._last = None
        state = simulate(ctx.n, ctx.family.gates(ctx.cfg, p), ctx.device, tf32=self.tf32)
        text = self._counts(state, seed) if self.shots else None
        self._last = state
        return Outcome(0, text, state.index_select(0, ctx.idx))

    def _counts(self, state, seed: int) -> str:
        import torch

        n = self.ctx.n
        cdf = torch.cumsum(state.abs().double().square(), 0)
        gen = torch.Generator(device=state.device).manual_seed(seed % (1 << 63))
        u = torch.rand(self.shots, generator=gen, device=state.device,
                       dtype=torch.float64) * cdf[-1]
        drawn = torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)
        del cdf
        if self.flip:
            drawn ^= 1 << (n - 1)
        vals, counts = np.unique(drawn.cpu().numpy(), return_counts=True)
        return "".join(f"  |{int(v):0{n}b}>: {int(c)}\n" for v, c in zip(vals, counts))

    def answer(self):
        return self._last

    def release(self):
        self._last = None


def make(ctx):
    return Control(ctx)
