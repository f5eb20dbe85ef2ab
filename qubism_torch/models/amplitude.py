"""Quantum amplitude estimation without QPE: maximum-likelihood AE.

Counterpart of qubism_tpu/models/amplitude.py. Every circuit of the
schedule is a prim stream for the port's ``CompiledCircuit``: the two
reflections are whole-register diagonals, one K2 factor each (the diag
kernel splits a factor wider than its tables into (mask, phase) pairs).

Given a state-preparation circuit ``A`` (a prim stream on ``n`` qubits) and a
set of "good" computational basis states ``G``, the amplitude is

    a = sum_{x in G} |<x| A |0>|^2 = sin^2(theta).

The Grover iterate Q = A S_0 A^dag S_G rotates the state by 2*theta in the
(good, bad) plane, so a measurement after ``Q^m A |0>`` finds a good outcome
with probability sin^2((2m+1) theta).  MLAE (Suzuki et al., "Amplitude
estimation without phase estimation", 2020) runs a schedule of powers m_k,
collects shot counts, and maximizes the joint likelihood over theta — the
estimation error scales like 1/N_q (N_q = total oracle queries) versus the
classical 1/sqrt(N), with NO controlled-Q and NO ancilla register, which is
exactly the shape that suits this engine: every circuit in the schedule is a
plain prim stream for ``CompiledCircuit``.

Engine shape: the reflections S_G (phase flip on good states) and S_0
(phase flip on |0...0>) are each ONE whole-register diagonal prim — a single
fused diagonal pass — instead of the multi-controlled-Z ancilla cascades a
gate-level construction needs; A^dag is the reversed conjugate-transpose
stream.  The schedule shares work: the state is evolved incrementally, m_k -
m_{k-1} extra iterates per step, so the whole schedule costs max(m_k) + 1
circuit applications rather than sum(m_k).

The reference has no algorithm library at all (its surface stops at running
hand-written QASM through src/Qubism/QASM/Simulation.hs); this module is an
engine extension in the spirit of models/{circuits,shor,xeb}.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..core.gates import Prim
from ..ops.fusion import CompiledCircuit

_MAX_N = 16  # full-register diagonal reflections: demo scale, like grover_prims


def invert_prims(prims) -> list[Prim]:
    """The prim stream of the inverse circuit: reversed order, each unitary
    conjugate-transposed (diagonals just conjugate)."""
    out = []
    for p in reversed(list(prims)):
        u = np.conj(p.u) if p.diag else p.u.conj().T
        out.append(Prim(u, p.targets, p.diag))
    return out


def reflection_prim(n: int, indices) -> Prim:
    """S = I - 2 sum_{x in indices} |x><x| as one whole-register diagonal."""
    if isinstance(indices, int):
        indices = (indices,)
    d = np.ones(1 << n, dtype=np.complex128)
    for x in indices:
        if not 0 <= x < (1 << n):
            raise ValueError(f"basis index {x} out of range for n={n}")
        d[x] = -1.0
    return Prim(d, tuple(range(n)), diag=True)


def grover_iterate_prims(a_prims, n: int, good) -> list[Prim]:
    """Q = A S_0 A^dag S_G as a prim stream (S_G applies first).

    Global phase is irrelevant to the sin^2((2m+1) theta) law, so the
    textbook leading minus sign is dropped."""
    if not 1 <= n <= _MAX_N:
        raise ValueError(f"amplitude estimation is demo-scale: 1 <= n <= {_MAX_N}")
    a_prims = list(a_prims)
    return ([reflection_prim(n, good)]
            + invert_prims(a_prims)
            + [reflection_prim(n, 0)]
            + a_prims)


def _good_probability(amps: np.ndarray, good) -> float:
    if isinstance(good, int):
        good = (good,)
    idx = np.fromiter(good, dtype=np.int64)
    return float(np.sum(np.abs(amps[idx]) ** 2))


def amplitude_exact(a_prims, n: int, good) -> float:
    """a = P(good) of A|0>, computed by one compiled run (the oracle answer
    MLAE is estimating)."""
    c = CompiledCircuit(n, list(a_prims))
    amps = c.state_to_complex(c(c.init_state()))
    return _good_probability(amps, good)


def schedule_probabilities(a_prims, n: int, good, schedule) -> list[float]:
    """Exact P(good) after Q^{m} A|0> for each m in ``schedule`` (ascending),
    evolving ONE state incrementally through the shared-prefix circuits."""
    schedule = sorted(int(m) for m in schedule)
    if schedule and schedule[0] < 0:
        raise ValueError("schedule powers must be >= 0")
    a_prims = list(a_prims)
    c_a = CompiledCircuit(n, a_prims)
    state = c_a(c_a.init_state())
    c_q = CompiledCircuit(n, grover_iterate_prims(a_prims, n, good))
    probs, m_cur = [], 0
    for m in schedule:
        for _ in range(m - m_cur):
            state = c_q(state)
        m_cur = m
        probs.append(_good_probability(c_a.state_to_complex(state), good))
    return probs


@dataclass(frozen=True)
class MLAEResult:
    a_hat: float                  # estimated amplitude sin^2(theta_hat)
    theta_hat: float
    a_exact: float                # exact P(good) of A|0> (simulator oracle)
    schedule: tuple[int, ...]     # Grover powers m_k
    shots: int                    # shots per schedule point
    hits: tuple[int, ...]         # good-outcome counts per point
    probs: tuple[float, ...]      # exact per-point P(good) the shots were drawn from
    queries: int                  # total oracle (A or A^dag) applications

    def __repr__(self):  # pragma: no cover - cosmetic
        return (f"MLAEResult(a_hat={self.a_hat:.6f}, a_exact={self.a_exact:.6f}, "
                f"queries={self.queries}, schedule={self.schedule})")


def _log_likelihood(theta: np.ndarray, schedule, hits, shots: int) -> np.ndarray:
    """Joint Bernoulli log-likelihood on a theta grid (vectorized)."""
    ll = np.zeros_like(theta)
    eps = 1e-12
    for m, h in zip(schedule, hits):
        p = np.sin((2 * m + 1) * theta) ** 2
        p = np.clip(p, eps, 1.0 - eps)
        ll += h * np.log(p) + (shots - h) * np.log1p(-p)
    return ll


def mlae_estimate(a_prims, n: int, good, schedule=None, shots: int = 128,
                  seed: int = 0, grid: int = 4096) -> MLAEResult:
    """Maximum-likelihood amplitude estimation.

    ``schedule`` defaults to the exponential Suzuki schedule
    [0, 1, 2, 4, 8, 16, 32] — 7 points, max power 2^5.  Shots are drawn from the engine's
    exact per-circuit Bernoulli (binomial draws on the host PRNG — the
    good/bad marginal of the engine's own sampler), seeded for
    reproducibility.  The likelihood is maximized on a dense theta grid and
    refined by golden-section search around the peak.
    """
    if schedule is None:
        schedule = [0] + [1 << k for k in range(6)]
    schedule = sorted(int(m) for m in schedule)
    probs = schedule_probabilities(a_prims, n, good, schedule)
    rng = np.random.default_rng(seed)
    hits = [int(rng.binomial(shots, p)) for p in probs]

    theta = np.linspace(1e-6, math.pi / 2 - 1e-6, grid)
    ll = _log_likelihood(theta, schedule, hits, shots)
    i = int(np.argmax(ll))
    lo = theta[max(i - 1, 0)]
    hi = theta[min(i + 1, grid - 1)]
    # golden-section refinement of the (locally unimodal) peak
    gr = (math.sqrt(5) - 1) / 2
    for _ in range(60):
        d = gr * (hi - lo)
        x1, x2 = hi - d, lo + d
        f1 = _log_likelihood(np.array([x1]), schedule, hits, shots)[0]
        f2 = _log_likelihood(np.array([x2]), schedule, hits, shots)[0]
        if f1 > f2:
            hi = x2
        else:
            lo = x1
    theta_hat = 0.5 * (lo + hi)
    a_exact = probs[0] if schedule and schedule[0] == 0 else \
        amplitude_exact(a_prims, n, good)
    queries = sum(2 * m + 1 for m in schedule)
    return MLAEResult(
        a_hat=float(math.sin(theta_hat) ** 2),
        theta_hat=float(theta_hat),
        a_exact=float(a_exact),
        schedule=tuple(schedule),
        shots=shots,
        hits=tuple(hits),
        probs=tuple(float(p) for p in probs),
        queries=queries,
    )
