"""Standard Pauli-sum Hamiltonians for the expectation and VQE APIs.

Counterpart of qubism_tpu/models/hamiltonians.py. Each builder returns
``(terms, constant)`` with ``terms`` a list of ``(coefficient,
pauli_string)``: the format every expectation surface takes
(``StateVec.expectation_sum``, ``ShardedSim.expectation_sum``,
``models.variational.energy_fn`` and the gradient engines). Host code only.
"""

from __future__ import annotations


def _one(n: int, c: str, q: int) -> str:
    s = ["I"] * n
    s[q] = c
    return "".join(s)


def _two(n: int, c1: str, q1: int, c2: str, q2: int) -> str:
    s = ["I"] * n
    s[q1] = c1
    s[q2] = c2
    return "".join(s)


def tfim(n: int, j: float = 1.0, h: float = 1.0, periodic: bool = False):
    """Transverse-field Ising model H = -J sum ZZ - h sum X."""
    terms = []
    last = n if periodic and n > 2 else n - 1
    for q in range(last):
        terms.append((-j, _two(n, "Z", q, "Z", (q + 1) % n)))
    for q in range(n):
        terms.append((-h, _one(n, "X", q)))
    return terms, 0.0


def heisenberg_xxz(n: int, jxy: float = 1.0, jz: float = 1.0,
                   field: float = 0.0, periodic: bool = False):
    """XXZ chain H = sum Jxy (XX + YY) + Jz ZZ + field sum Z."""
    terms = []
    last = n if periodic and n > 2 else n - 1
    for q in range(last):
        r = (q + 1) % n
        terms.append((jxy, _two(n, "X", q, "X", r)))
        terms.append((jxy, _two(n, "Y", q, "Y", r)))
        terms.append((jz, _two(n, "Z", q, "Z", r)))
    if field:
        terms.extend((field, _one(n, "Z", q)) for q in range(n))
    return terms, 0.0


def h2_minimal():
    """The reduced 2-qubit molecular H2 Hamiltonian at the equilibrium
    bond length (O'Malley et al. 2016 coefficients), in Hartree."""
    terms = [(0.3435, "ZI"), (-0.4347, "IZ"), (0.5716, "ZZ"),
             (0.0910, "XX"), (0.0910, "YY")]
    return terms, -0.4804


def maxcut(n: int, edges):
    """<C> = constant + sum terms counts cut edges (see
    :func:`qubism_torch.models.variational.maxcut_terms`)."""
    from .variational import maxcut_terms

    return maxcut_terms(n, edges)
