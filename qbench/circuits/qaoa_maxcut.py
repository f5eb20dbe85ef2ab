"""QAOA for MaxCut (Farhi, Goldstone and Gutmann, arXiv:1411.4028, 2014) on
the configuration's graph, a family that returns numbers and no state:
each program is one optimiser step, the MaxCut value and its gradient at
angles drawn from the program's seed.

The circuit is the layout of the port's ``qaoa_maxcut_ansatz``: H on every
qubit, then in layer l = 0..p-1 exp(-i gamma_l Z_a Z_b) on every edge (a,
b) in the configuration's order and exp(-i beta_l X) on every qubit;
theta = [gamma_0..gamma_{p-1}, beta_0..beta_{p-1}]. The value is the
MaxCut objective <sum_edges (1 - Z_a Z_b) / 2>, the gradient its
derivative by each entry of theta, from the plain adjoint reference
(:mod:`qbench.reference.adjoint`).

The graph is drawn once by :func:`regular_graph` and written into the
configuration as its edges.
"""

from __future__ import annotations

import math

import numpy as np

from qbench.reference import adjoint

_H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / math.sqrt(2)


def regular_graph(n: int, degree: int, seed: int) -> list[list[int]]:
    """A random ``degree``-regular graph on n vertices by the pairing model
    (Bollobas 1980): n * degree stubs in a random order, paired off two by
    two; a draw with a self-loop or a repeated edge is thrown away and the
    next one taken from the same generator. The edges as sorted [a, b],
    a < b, in sorted order."""
    rng = np.random.default_rng(seed)
    while True:
        pairs = rng.permutation(np.repeat(np.arange(n), degree)).reshape(-1, 2)
        edges = {(int(min(a, b)), int(max(a, b))) for a, b in pairs}
        if len(edges) == len(pairs) and all(a != b for a, b in edges):
            return [[a, b] for a, b in sorted(edges)]


def draw(cfg: dict, seed: int) -> dict:
    """The step's angles: gamma_0..gamma_{p-1}, beta_0..beta_{p-1}, each
    uniform in [0, pi) and a float32."""
    t = np.random.default_rng(seed).uniform(0, math.pi, 2 * cfg["p_layers"])
    return {"theta": [float(x) for x in t.astype(np.float32)]}


def circuit(cfg: dict, theta, shift: tuple[int, float] | None = None) -> list:
    """The gate list of :mod:`qbench.reference.adjoint` at ``theta``;
    ``shift`` (k, s) adds s to the angle of the k-th parameterised gate
    alone (the parameter-shift rule's circuits)."""
    n, edges, p = cfg["num_qubits"], cfg["edges"], cfg["p_layers"]
    out = [(_H, (q,), False, None) for q in range(n)]
    k = 0
    for layer in range(p):
        for a, b in edges:
            g = theta[layer] + (shift[1] if shift and shift[0] == k else 0.0)
            e = np.exp(-1j * g)
            out.append((np.array([e, e.conjugate(), e.conjugate(), e]), (a, b), True,
                        (layer, 1.0, "ZZ")))
            k += 1
        for q in range(n):
            t = theta[p + layer] + (shift[1] if shift and shift[0] == k else 0.0)
            c, s = math.cos(t), math.sin(t)
            out.append((np.array([[c, -1j * s], [-1j * s, c]]), (q,), False,
                        (p + layer, 1.0, "X")))
            k += 1
    return out


def terms(cfg: dict) -> tuple[list, float]:
    """The MaxCut value as constant + sum_k c_k Z_a Z_b: ([(c_k, (a, b))],
    constant)."""
    return [(-0.5, (a, b)) for a, b in cfg["edges"]], 0.5 * len(cfg["edges"])


def numbers(cfg: dict, p: dict, device, tf32: bool = False) -> dict[str, np.ndarray]:
    zterms, constant = terms(cfg)
    value, grad = adjoint.value_and_grad(cfg["num_qubits"], circuit(cfg, p["theta"]), zterms,
                                         2 * cfg["p_layers"], device, tf32=tf32)
    return {"value": np.array([constant + value]), "grad": grad}
