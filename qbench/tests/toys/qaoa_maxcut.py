"""QAOA for MaxCut (Farhi, Goldstone and Gutmann, arXiv:1411.4028) on the
configuration's graph, as a family that returns numbers and no state: each
program is one optimiser step's energy and gradient at angles drawn from
its seed. The tests copy this file into a throwaway checkout's
``qbench/circuits/`` to drive the check's ``numbers`` hook.

The plain reference (:func:`numbers`) runs ``qbench.reference.simulate``
over the circuit's gate list: H on every qubit, then in layer l exp(-i
gamma_l Z_a Z_b) on every edge and exp(-i beta_l X) on every qubit. The
value is the MaxCut objective <sum_edges (1 - Z_a Z_b) / 2>; its gradient
is taken by the parameter-shift rule, gate by gate (each gate is exp(-i t
P) with P^2 = 1, so d<E>/dt = <E>(t + pi/4) - <E>(t - pi/4)), summed over
the gates that share an angle.
"""

from __future__ import annotations

import math

import numpy as np

from qbench.reference import simulate

_H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / math.sqrt(2)


def draw(cfg: dict, seed: int) -> dict:
    """The step's angles: gamma_0..gamma_{p-1}, beta_0..beta_{p-1} in
    [0, pi), each a float32."""
    t = np.random.default_rng(seed).uniform(0, math.pi, 2 * cfg["p_layers"])
    return {"theta": [float(x) for x in t.astype(np.float32)]}


def _gates(cfg: dict, theta, shift: tuple[int, float] | None = None) -> list:
    """The gate list; ``shift`` (k, s) adds s to the angle of the k-th
    parameterised gate alone."""
    n, edges, p = cfg["num_qubits"], cfg["edges"], cfg["p_layers"]
    out = [(_H, (q,), False) for q in range(n)]
    k = 0
    for layer in range(p):
        for a, b in edges:
            g = theta[layer] + (shift[1] if shift and shift[0] == k else 0.0)
            e = np.exp(-1j * g)
            out.append((np.array([e, e.conjugate(), e.conjugate(), e]), (a, b), True))
            k += 1
        for q in range(n):
            t = theta[p + layer] + (shift[1] if shift and shift[0] == k else 0.0)
            c, s = math.cos(t), math.sin(t)
            out.append((np.array([[c, -1j * s], [-1j * s, c]]), (q,), False))
            k += 1
    return out


def _owners(cfg: dict) -> list[int]:
    """The parameter of each parameterised gate, in the gate list's order."""
    n, edges, p = cfg["num_qubits"], cfg["edges"], cfg["p_layers"]
    return [j for layer in range(p) for j in [layer] * len(edges) + [p + layer] * n]


def _value(cfg: dict, state) -> float:
    n = cfg["num_qubits"]
    prob = state.abs().double().square().cpu().numpy()
    x = np.arange(1 << n)
    z = [1 - 2 * ((x >> (n - 1 - q)) & 1) for q in range(n)]
    return float(sum(0.5 * (1 - prob @ (z[a] * z[b])) for a, b in cfg["edges"]))


def numbers(cfg: dict, p: dict, device, tf32: bool = False) -> dict[str, np.ndarray]:
    n, theta = cfg["num_qubits"], p["theta"]

    def value(shift=None):
        return _value(cfg, simulate(n, _gates(cfg, theta, shift), device, tf32=tf32))

    grad = np.zeros(len(theta))
    for k, j in enumerate(_owners(cfg)):
        grad[j] += value((k, math.pi / 4)) - value((k, -math.pi / 4))
    return {"value": np.array([value()]), "grad": grad}
