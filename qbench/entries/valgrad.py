"""An optimiser's step through the port's variational path:
``adjoint_value_and_grad_fn`` on the family's QAOA MaxCut ansatz and the
MaxCut terms, with its default ``engine="auto"``, as
``vqe_minimize(grad="adjoint")`` calls it; one value and one gradient a
program at the program's angles. On a CUDA card ``"auto"`` has to pick the
kernel adjoint engine (``models/adjoint_engine.py``) whose gradient walks
add into one buffer on the card (its ``_contract`` is ``"device"``), or
set-up fails: an engine that reads each walk back from a host loop makes
some 275,000 profiled events a program, more than a traced run of the cell
can read within the run's limit."""

from __future__ import annotations

import numpy as np

from qbench.harness import Outcome


class ValGrad:
    def __init__(self, ctx):
        from qubism_torch.models.variational import (adjoint_value_and_grad_fn,
                                                     maxcut_terms, qaoa_maxcut_ansatz)

        self.ctx = ctx
        n, edges = ctx.n, [tuple(e) for e in ctx.cfg["edges"]]
        terms, constant = maxcut_terms(n, edges)
        self.fn = adjoint_value_and_grad_fn(qaoa_maxcut_ansatz(n, edges, ctx.cfg["p_layers"]),
                                            terms, constant)
        if ctx.device.type == "cuda" and self.fn._engine != "kernels":
            raise RuntimeError(f"qbench: engine 'auto' picked {self.fn._engine!r} on the card, "
                               "not the kernel adjoint engine")
        if ctx.device.type == "cuda" and getattr(self.fn, "_contract", None) != "device":
            raise RuntimeError("qbench: the kernel adjoint engine reads its gradient walks "
                               "back one by one; the cell needs them summed on the card")

    def prepare(self, p: dict, seed: int):
        import torch

        return torch.tensor(p["theta"], dtype=torch.float32)

    def program(self, theta) -> Outcome:
        value, grad = self.fn(theta)
        return Outcome(0, numbers={"value": np.atleast_1d(value.numpy()).astype(np.float64),
                                   "grad": grad.numpy().astype(np.float64)})

    def release(self):
        """phi and lam live only inside a call; drop the engine and hand the
        allocator's cached blocks back to the card before the references."""
        import torch

        self.fn = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def make(ctx):
    return ValGrad(ctx)
