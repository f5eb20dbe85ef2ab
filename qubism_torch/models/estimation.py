"""Shot-based Hamiltonian estimation: the hardware-realistic readout loop.

Counterpart of qubism_tpu/models/estimation.py. The exact engines report
``<H>`` in one reduction (:func:`qubism_torch.ops.measure.expectation_pauli_sum`);
real devices instead measure in the computational basis and must (a)
rotate every Pauli string into Z's, (b) share shots between simultaneously
measurable strings, and (c) optimize through the resulting noise. This
module is that loop on the simulator's sampler:

* :func:`qwc_groups` — greedy first-fit partition of Pauli strings into
  qubit-wise commuting (QWC) groups: two strings share a group iff at
  every qubit their letters agree or one is I, so ONE basis-rotated
  shot batch serves the whole group (Verteletskyi et al.,
  arXiv:1907.03358's baseline partition).
* :class:`EnergyEstimator` — per group: apply the H / H S^dag basis
  rotations to a copy of the state (one ``CompiledCircuit`` per group,
  built once), draw shots with the port's inverse-CDF sampler
  (``ops.sample.sample_indices``, a CPU ``torch.Generator``), and read every
  member string's value as a parity of the sampled INDICES (no 2^n sign
  tables — works at any engine size); shots split across groups uniformly
  or by total |coefficient| weight. Returns (mean, stderr) with the exact
  per-shot sample variance, identity terms folded in exactly.
* :func:`estimate_energy_fn` — ``(theta, seed) -> (E, stderr)`` for an
  ansatz: the port's ``state_fn`` per call, then grouped sampling.
* :func:`spsa_minimize` — simultaneous-perturbation stochastic
  approximation (Spall 1992): 2 noisy evaluations per step regardless
  of dimension, the standard optimizer for shot-noise objectives. Its
  perturbations come from numpy, as the JAX package draws them.

Engine extension: the reference has no observables, no sampling beyond
full-register measurement, and no optimization (src/Qubism/QASM/* has
no analogue of any of this).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from ..ops import measure as _measure
from ..ops import sample as _sample
from ..ops.fusion import CompiledCircuit
from .tomography import _basis_rotation_prims

__all__ = ["qwc_groups", "EnergyEstimator", "estimate_pauli_sum",
           "estimate_energy_fn", "spsa_minimize"]


def qwc_groups(paulis: Sequence[str]) -> tuple[list[list[int]], list[str]]:
    """Partition ``paulis`` (uppercase IXYZ strings of equal length) into
    qubit-wise commuting groups, greedy first-fit in input order.

    Returns ``(groups, bases)``: ``groups[g]`` is the member indices and
    ``bases[g]`` the group's joint measurement basis — at each qubit the
    single non-I letter its members use there (I where none does).
    """
    groups: list[list[int]] = []
    bases: list[list[str]] = []
    for j, p in enumerate(paulis):
        for g, basis in zip(groups, bases):
            if all(c == "I" or basis[q] in ("I", c)
                   for q, c in enumerate(p)):
                for q, c in enumerate(p):
                    if c != "I":
                        basis[q] = c
                g.append(j)
                break
        else:
            groups.append([j])
            bases.append(list(p))
    return groups, ["".join(b) for b in bases]


def _support_mask(pauli: str, n: int) -> int:
    m = 0
    for q, c in enumerate(pauli):
        if c != "I":
            m |= 1 << (n - 1 - q)
    return m


def _parity_pm1_np(x: np.ndarray) -> np.ndarray:
    """Elementwise (-1)^popcount for a sampled int64 index array."""
    x = x.astype(np.int64, copy=True)
    for sh in (32, 16, 8, 4, 2, 1):
        x ^= x >> sh
    return 1.0 - 2.0 * (x & 1).astype(np.float64)


class EnergyEstimator:
    """Shot-based ``sum_j c_j <P_j>`` estimation on a prepared state.

    ``estimate(state, gen)`` consumes a complex64 state tensor from any
    statevector surface (``state_fn``, ``CompiledCircuit``, a Session)
    WITHOUT mutating it, draws with the CPU ``torch.Generator`` ``gen``,
    and returns ``(mean, stderr)``. The member rotation circuits are
    planned once per group at construction and reused across calls — the
    VQE-loop shape.
    """

    def __init__(self, n: int, terms, shots: int = 4096,
                 grouping: str = "qwc", allocation: str = "weighted",
                 constant: float = 0.0):
        if grouping not in ("qwc", "none"):
            raise ValueError(f"unknown grouping {grouping!r}")
        if allocation not in ("weighted", "uniform"):
            raise ValueError(f"unknown allocation {allocation!r}")
        self.n = n
        self.shots = int(shots)
        checked = [(float(c), _measure._check_pauli(p, n)) for c, p in terms]
        self.exact = constant + sum(
            c for c, p in checked if set(p) == {"I"})
        sampled = [(c, p) for c, p in checked if set(p) != {"I"}]
        paulis = [p for _, p in sampled]
        if grouping == "qwc":
            groups, bases = qwc_groups(paulis)
        else:
            groups, bases = [[j] for j in range(len(paulis))], list(paulis)
        self._groups = []
        weights = []
        for g, basis in zip(groups, bases):
            rot = _basis_rotation_prims(basis)
            circ = CompiledCircuit(n, rot) if rot else None
            masks = np.asarray([_support_mask(paulis[j], n) for j in g],
                               dtype=np.int64)
            coefs = np.asarray([sampled[j][0] for j in g], dtype=np.float64)
            self._groups.append((circ, masks, coefs))
            weights.append(float(np.abs(coefs).sum()))
        w = np.asarray(weights, dtype=np.float64)
        if allocation == "uniform" or w.sum() == 0.0:
            w = np.ones_like(w)
        shares = w / w.sum() if len(w) else w
        self._shots_per_group = [max(1, int(round(self.shots * s)))
                                 for s in shares]

    @property
    def num_groups(self) -> int:
        return len(self._groups)

    def estimate(self, state: torch.Tensor, gen: torch.Generator) -> tuple[float, float]:
        total = self.exact
        var = 0.0
        for (circ, masks, coefs), sg in zip(self._groups,
                                            self._shots_per_group):
            # a CompiledCircuit updates its state in place: rotate a copy
            rotated = circ(state.clone()) if circ is not None else state
            idx = _sample.sample_indices(rotated, self.n, sg, gen).astype(np.int64)
            del rotated
            # (shots, k) parities -> per-shot group value
            signs = _parity_pm1_np(idx[:, None] & masks[None, :])
            vals = signs @ coefs
            total += float(vals.mean())
            if sg > 1:
                var += float(vals.var(ddof=1)) / sg
        return total, math.sqrt(var)


def estimate_pauli_sum(prims, n: int, terms, shots: int = 4096,
                       seed: int = 0, grouping: str = "qwc",
                       allocation: str = "weighted",
                       constant: float = 0.0) -> tuple[float, float]:
    """One-call form: prepare the state from a prim stream and estimate
    ``constant + sum_j c_j <P_j>`` from grouped basis-rotated shots."""
    est = EnergyEstimator(n, terms, shots, grouping, allocation, constant)
    c = CompiledCircuit(n, list(prims))
    state = c(c.init_state())
    return est.estimate(state, torch.Generator().manual_seed(int(seed)))


def estimate_energy_fn(ansatz, terms, shots: int = 4096,
                       grouping: str = "qwc", allocation: str = "weighted",
                       constant: float = 0.0) -> Callable:
    """``(theta, seed=0) -> (E_est, stderr)``: the shot-based counterpart
    of :func:`variational.energy_fn` — the state of :func:`variational.state_fn`
    per call, then grouped sampling."""
    from .variational import state_fn

    est = EnergyEstimator(ansatz.n, terms, shots, grouping, allocation,
                          constant)
    run = state_fn(ansatz)

    def f(theta, seed: int = 0):
        with torch.no_grad():
            state = run(theta)
        return est.estimate(state, torch.Generator().manual_seed(int(seed)))

    f._estimator = est
    return f


def spsa_minimize(f: Callable, theta0, steps: int = 100, a: float = 0.15,
                  c: float = 0.1, alpha: float = 0.602,
                  gamma: float = 0.101, A: float | None = None,
                  seed: int = 0, avg_last: int = 10):
    """Minimize a NOISY objective with SPSA (Spall 1992): per step, ONE
    Rademacher direction Delta and two evaluations f(theta +/- c_k Delta)
    estimate the full gradient, so the cost per step is independent of
    the parameter count — the standard choice when every evaluation
    costs shots. ``f(theta, seed)`` may return a scalar or an
    ``(value, stderr)`` pair.

    Returns ``(theta_hat, history)``: the average of the last
    ``avg_last`` iterates (Polyak averaging flattens the shot-noise
    jitter) and the per-step evaluated values.
    """
    rng = np.random.default_rng(seed)
    theta = np.asarray(theta0, dtype=np.float64).copy()
    if A is None:
        A = 0.1 * steps
    history = []
    tail = []

    def val(x):
        return float(x[0]) if isinstance(x, tuple) else float(x)

    for k in range(steps):
        ak = a / (k + 1 + A) ** alpha
        ck = c / (k + 1) ** gamma
        delta = rng.choice((-1.0, 1.0), size=theta.shape)
        fp = val(f(theta + ck * delta, seed=int(rng.integers(2 ** 31))))
        fm = val(f(theta - ck * delta, seed=int(rng.integers(2 ** 31))))
        ghat = (fp - fm) / (2.0 * ck) * delta  # Delta_i in {-1,1}: 1/Delta = Delta
        theta = theta - ak * ghat
        history.append(0.5 * (fp + fm))
        tail.append(theta.copy())
        if len(tail) > avg_last:
            tail.pop(0)
    theta_hat = np.mean(np.asarray(tail), axis=0) if tail else theta
    return theta_hat, history
