"""An optimiser's step through the port's variational engine:
``adjoint_value_and_grad_fn`` on the family's QAOA MaxCut ansatz, one
energy and one gradient a program at the program's angles. The tests copy
this file into a throwaway checkout's ``qbench/entries/``."""

from __future__ import annotations

import numpy as np

from qbench.harness import Outcome


class ValGrad:
    def __init__(self, ctx):
        from qubism_torch.models.variational import (adjoint_value_and_grad_fn,
                                                     maxcut_terms, qaoa_maxcut_ansatz)

        n, edges = ctx.n, [tuple(e) for e in ctx.cfg["edges"]]
        terms, constant = maxcut_terms(n, edges)
        self.fn = adjoint_value_and_grad_fn(qaoa_maxcut_ansatz(n, edges, ctx.cfg["p_layers"]),
                                            terms, constant)

    def prepare(self, p: dict, seed: int):
        import torch

        return torch.tensor(p["theta"], dtype=torch.float32)

    def program(self, theta) -> Outcome:
        value, grad = self.fn(theta)
        return Outcome(0, numbers={"value": np.atleast_1d(value.numpy()).astype(np.float64),
                                   "grad": grad.numpy().astype(np.float64)})


def make(ctx):
    return ValGrad(ctx)
