"""The control of the check: the plain reference in the program's place.

Each program is :func:`qbench.reference.simulate` of the program's gate
list with every product's inputs rounded to TF32 (``tf32``), one precision
below the float32 the configuration states, where the cell checks a state
or takes shots; they are drawn from the family's distribution of that
state (``qbench.check.distribution``) by a float64 inverse CDF and printed
as the CLI prints its counts. Where the family has ``numbers``, the
program's numbers are the family's own, with the same rounding. With
``flip_shots`` the state is the float32 reference's and each shot's first
bit is flipped where it is drawn: the fault that the shots' number has to
catch. ``python3 -m qbench.control`` runs these through the harness; the
benchmark's own runs never do.
"""

from __future__ import annotations

import numpy as np

from qbench.check import distribution
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
        numbers = (ctx.family.numbers(ctx.cfg, p, ctx.device, tf32=self.tf32)
                   if hasattr(ctx.family, "numbers") else None)
        if ctx.idx is None and not self.shots:
            return Outcome(0, numbers=numbers)
        state = simulate(ctx.n, ctx.family.gates(ctx.cfg, p), ctx.device, tf32=self.tf32)
        text = self._counts(distribution(ctx.family, ctx.cfg, state), seed) \
            if self.shots else None
        self._last = state
        fp = state.index_select(0, ctx.idx) if ctx.idx is not None else None
        return Outcome(0, text, fp, numbers=numbers)

    def _counts(self, probs, seed: int) -> str:
        import torch

        bits = probs.numel().bit_length() - 1
        cdf = torch.cumsum(probs.double(), 0)
        gen = torch.Generator(device=probs.device).manual_seed(seed % (1 << 63))
        u = torch.rand(self.shots, generator=gen, device=probs.device,
                       dtype=torch.float64) * cdf[-1]
        drawn = torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)
        del cdf
        if self.flip:
            drawn ^= 1 << (bits - 1)
        vals, counts = np.unique(drawn.cpu().numpy(), return_counts=True)
        return "".join(f"  |{int(v):0{bits}b}>: {int(c)}\n" for v, c in zip(vals, counts))

    def answer(self):
        return self._last

    def release(self):
        self._last = None


def make(ctx):
    return Control(ctx)
