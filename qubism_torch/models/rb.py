"""Randomized benchmarking (RB) on the simulator's noise engines.

Counterpart of qubism_tpu/models/rb.py, run on the port's
``DensityMatrix``, its trajectory engine and, for simultaneous RB at
scale, its Pauli-frame executor (``StabilizerTrajectoryProgram``). The
Clifford groups and every sequence are drawn by numpy as the JAX package
draws them, so a seed gives the same circuits in both packages.

Standard Clifford RB (Magesan et al. 2011): apply m uniformly random
Clifford gates followed by the single Clifford that inverts their product,
interleave the noise channel, and record the survival probability
P(measure |0..0>).  Averaged over sequences the survival decays as

    F(m) = A alpha^m + B,   B = 1/d,  A = 1 - 1/d,  d = 2^k

(no SPAM error in a simulator), and the average gate infidelity is
r = (d-1)/d * (1 - alpha).  For the engine's random-Pauli depolarizing
channels (core/density.py: probability p of a uniform non-identity Pauli)
the decay is exactly alpha = 1 - p d^2/(d^2-1): 1 - 4p/3 for k=1 and
1 - 16p/15 for k=2.

The Clifford groups are generated numerically by closure over {H, S}
(k=1, 24 elements) and {H0, H1, S0, S1, CZ} (k=2, 11520 elements),
canonicalized up to global phase; sequence inverses are one dict lookup of
the phase-canonical product.  Survivals come from either

* the exact DensityMatrix engine (k-qubit rho is 2^k x 2^k — exact,
  deterministic; the default), or
* the MCWF trajectory engine (``executor="trajectories"``) —
  the same channel spec the ``--noise`` CLI path uses.

Engine extension: the reference has no noise model and no benchmarking
protocols at all (pure states only, src/Qubism/StateVec.hs)."""

from __future__ import annotations

import functools
import math

import numpy as np

from ..core.density import DensityMatrix
from ..core.gates import Prim

_H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / math.sqrt(2)
_S = np.diag([1, 1j]).astype(np.complex128)
_CZ = np.diag([1, 1, 1, -1]).astype(np.complex128)


def _canon(u: np.ndarray) -> bytes:
    """Phase-canonical byte key: first non-negligible entry made real
    positive, then rounded.  Two unitaries equal up to global phase map to
    the same key."""
    flat = u.ravel()
    k = int(np.argmax(np.abs(flat) > 1e-8))
    z = flat[k]
    v = u * (abs(z) / z)
    # quantize to integers: float bytes would distinguish -0.0 from +0.0
    q = np.round(np.stack([v.real, v.imag]) * 1e5).astype(np.int64)
    return q.tobytes()


@functools.lru_cache(maxsize=None)
def clifford_group(k: int) -> tuple[np.ndarray, ...]:
    """All k-qubit Clifford unitaries up to global phase (k = 1 or 2):
    24 / 11520 matrices, generated by BFS closure."""
    if k == 1:
        gens = [_H, _S]
    elif k == 2:
        i2 = np.eye(2)
        gens = [np.kron(_H, i2), np.kron(i2, _H),
                np.kron(_S, i2), np.kron(i2, _S), _CZ]
    else:
        raise ValueError("clifford_group supports k in {1, 2}")
    seen = {}
    frontier = [np.eye(1 << k, dtype=np.complex128)]
    seen[_canon(frontier[0])] = 0
    elems = [frontier[0]]
    while frontier:
        nxt = []
        for u in frontier:
            for g in gens:
                v = g @ u
                key = _canon(v)
                if key not in seen:
                    seen[key] = len(elems)
                    elems.append(v)
                    nxt.append(v)
        frontier = nxt
    return tuple(elems)


@functools.lru_cache(maxsize=None)
def _index(k: int) -> dict:
    return {_canon(u): i for i, u in enumerate(clifford_group(k))}


def inverse_index(k: int, u: np.ndarray) -> int:
    """Index of the group element equal (up to phase) to u^dagger."""
    return _index(k)[_canon(u.conj().T)]


def rb_sequence(k: int, m: int, rng: np.random.Generator) -> list[int]:
    """m uniform Clifford indices plus the closing inverse index."""
    group = clifford_group(k)
    seq = [int(rng.integers(len(group))) for _ in range(m)]
    total = np.eye(1 << k, dtype=np.complex128)
    for i in seq:
        total = group[i] @ total
    seq.append(inverse_index(k, total))
    return seq


def rb_prims(k: int, seq, targets=None) -> list[Prim]:
    group = clifford_group(k)
    if targets is None:
        targets = tuple(range(k))
    return [Prim(group[i], tuple(targets)) for i in seq]


def _survival_density(k: int, seq, kraus) -> float:
    """Exact survival: rho through the sequence with ``kraus`` after every
    Clifford except the closing inverse (standard RB convention benchmarks
    the m random gates; the recovery gate is ideal here)."""
    rho = DensityMatrix(k)
    targets = tuple(range(k))
    prims = rb_prims(k, seq)
    for p in prims[:-1]:
        rho = rho.apply([p])
        if kraus is not None:
            rho = rho.apply_channel(kraus, targets)
    rho = rho.apply([prims[-1]])
    return float(rho.probs()[0])


def _survival_trajectories(k: int, seq, kraus, ntraj: int, seed: int) -> float:
    from .trajectories import ChannelOp, run_trajectories, trajectory_probs

    targets = tuple(range(k))
    prims = rb_prims(k, seq)
    program = []
    for p in prims[:-1]:
        program.append(p)
        if kraus is not None:
            program.append(ChannelOp(kraus, targets))
    program.append(prims[-1])
    planes = run_trajectories(k, program, ntraj=ntraj, seed=seed)
    return float(trajectory_probs(planes)[0])


def rb_survivals(k: int, ms, kraus, n_seq: int = 8, seed: int = 0,
                 executor: str = "density", ntraj: int = 512) -> list[float]:
    """Mean survival probability per sequence length in ``ms``."""
    rng = np.random.default_rng(seed)
    out = []
    for m in ms:
        acc = 0.0
        for s in range(n_seq):
            seq = rb_sequence(k, int(m), rng)
            if executor == "density":
                acc += _survival_density(k, seq, kraus)
            elif executor == "trajectories":
                acc += _survival_trajectories(k, seq, kraus, ntraj,
                                              seed * 7919 + s)
            else:
                raise ValueError(f"unknown executor {executor!r}")
        out.append(acc / n_seq)
    return out


def fit_rb(ms, survivals, k: int):
    """Fit F(m) = A alpha^m + B with the simulator's SPAM-free B = 1/d,
    A = 1 - 1/d fixed; returns (alpha, r) with r = (d-1)/d (1-alpha)."""
    d = 1 << k
    b = 1.0 / d
    a = 1.0 - b
    ms = np.asarray(ms, dtype=np.float64)
    y = (np.asarray(survivals, dtype=np.float64) - b) / a
    # drop points at/below the 1/d floor instead of clipping them into the
    # log-linear fit: one noisy trajectory point clipped to 1e-12 would
    # inject log(1e-12) ~ -27.6 and wreck the alpha estimate
    keep = y > 0
    if keep.sum() < 2:
        raise ValueError(
            "fit_rb: fewer than 2 survival points above the 1/d floor; "
            "increase n_seq/ntraj or use shorter sequence lengths")
    slope = np.polyfit(ms[keep], np.log(y[keep]), 1)[0]
    alpha = float(np.exp(slope))
    r = (d - 1) / d * (1.0 - alpha)
    return alpha, r


def rb_experiment(k: int, kraus, ms=(1, 2, 4, 8, 16), n_seq: int = 8,
                  seed: int = 0, executor: str = "density",
                  ntraj: int = 512):
    """End-to-end RB: survivals + decay fit.  Returns
    (ms, survivals, alpha, r)."""
    surv = rb_survivals(k, ms, kraus, n_seq=n_seq, seed=seed,
                        executor=executor, ntraj=ntraj)
    alpha, r = fit_rb(ms, surv, k)
    return list(ms), surv, alpha, r


# -- simultaneous RB at scale on the stabilizer frame executor -------------------


@functools.lru_cache(maxsize=None)
def clifford_words() -> tuple[tuple[str, ...], ...]:
    """A {h, s} generator word (application order) for every 1q Clifford,
    index-aligned with clifford_group(1) — BFS gives shortest words."""
    group = clifford_group(1)
    idx = _index(1)
    words: dict[int, tuple[str, ...]] = {0: ()}
    frontier = [(np.eye(2, dtype=np.complex128), ())]
    gens = {"h": _H, "s": _S}
    while frontier:
        nxt = []
        for u, w in frontier:
            for name, g in gens.items():
                v = g @ u
                i = idx[_canon(v)]
                if i not in words:
                    words[i] = w + (name,)
                    nxt.append((v, w + (name,)))
        frontier = nxt
    assert len(words) == len(group)
    return tuple(words[i] for i in range(len(group)))


_QASM_GEN = {
    "h": "U(1.5707963267948966, 0, 3.141592653589793) q[{q}];",
    "s": "U(0, 0, 1.5707963267948966) q[{q}];",
}


def simultaneous_rb_qasm(n: int, m: int, rng: np.random.Generator):
    """Simultaneous 1q RB on n qubits as ONE final-measure QASM program
    (the shape the Pauli-FRAME executor runs at hundreds of qubits):
    every qubit gets its own m random Cliffords + closing inverse, each
    emitted as its {h, s} generator word in raw-U form.  Returns
    (qasm_text, per-qubit physical-gate counts) — under per-gate
    depolarizing(p) the exact survival of qubit i is
    1/2 + 1/2 (1-4p/3)^counts[i]."""
    group = clifford_group(1)
    words = clifford_words()
    lines = [f"qreg q[{n}];", f"creg c[{n}];"]
    counts = []
    for q in range(n):
        total = np.eye(2, dtype=np.complex128)
        word: list[str] = []
        for _ in range(m):
            i = int(rng.integers(len(group)))
            word += list(words[i])
            total = group[i] @ total
        word += list(words[inverse_index(1, total)])
        counts.append(len(word))
        lines += [_QASM_GEN[g].format(q=q) for g in word]
    lines.append("measure q -> c;")
    return "\n".join(lines) + "\n", counts


def simultaneous_rb_survivals(n: int, m: int, p: float, ntraj: int = 2048,
                              seed: int = 0):
    """Per-qubit survival probabilities from a noisy frame-executor run.
    Returns (survivals[n], expected[n], used_frames) where expected is the
    exact per-qubit law for the engine's depolarizing convention."""
    from ..qasm.parser import parse_openqasm
    from ..stabilizer.noise import StabilizerTrajectoryProgram

    rng = np.random.default_rng(seed)
    src, counts = simultaneous_rb_qasm(n, m, rng)
    prog = StabilizerTrajectoryProgram(parse_openqasm("<rb>", src),
                                       noise=f"dep:{p}")
    bits = prog.run_vals(ntraj, seed=seed)["c"]
    surv = (np.asarray(bits) == 0).mean(axis=0)
    alpha = 1.0 - 4.0 * p / 3.0
    expected = np.array([0.5 + 0.5 * alpha ** g for g in counts])
    return surv, expected, bool(getattr(prog, "used_frames", False))


# -- interleaved RB (Magesan et al. 2012) ---------------------------------------


def irb_sequence(k: int, m: int, gate_idx: int,
                 rng: np.random.Generator) -> list[int]:
    """C_1, G, C_2, G, ..., C_m, G, plus the inverse of the whole product:
    the interleaved-RB sequence for Clifford index ``gate_idx``."""
    group = clifford_group(k)
    g = group[gate_idx]
    seq: list[int] = []
    total = np.eye(1 << k, dtype=np.complex128)
    for _ in range(m):
        i = int(rng.integers(len(group)))
        seq += [i, gate_idx]
        total = g @ group[i] @ total
    seq.append(inverse_index(k, total))
    return seq


def _irb_survival_density(k: int, seq, kraus, gate_kraus) -> float:
    """Like _survival_density, but odd positions are the interleaved gate
    and carry ``gate_kraus`` (its private error channel) ON TOP of the
    background ``kraus``."""
    rho = DensityMatrix(k)
    targets = tuple(range(k))
    prims = rb_prims(k, seq)
    for j, p in enumerate(prims[:-1]):
        rho = rho.apply([p])
        if kraus is not None:
            rho = rho.apply_channel(kraus, targets)
        if j % 2 == 1 and gate_kraus is not None:
            rho = rho.apply_channel(gate_kraus, targets)
    rho = rho.apply([prims[-1]])
    return float(rho.probs()[0])


def irb_experiment(k: int, gate_idx: int, kraus, gate_kraus=None,
                   ms=(1, 2, 4, 8), n_seq: int = 8, seed: int = 0):
    """Interleaved RB: fit the reference decay alpha_ref (plain RB under
    ``kraus``) and the interleaved decay alpha_int (gate G after every
    random Clifford, with G's private ``gate_kraus`` on top), then

        r_G = (d-1)/d * (1 - alpha_int / alpha_ref)

    is the infidelity attributed to G alone.  Returns
    (alpha_ref, alpha_int, r_gate)."""
    surv_ref = rb_survivals(k, ms, kraus, n_seq=n_seq, seed=seed)
    alpha_ref, _ = fit_rb(ms, surv_ref, k)
    rng = np.random.default_rng(seed + 1)
    surv_int = []
    for m in ms:
        acc = 0.0
        for _ in range(n_seq):
            seq = irb_sequence(k, int(m), gate_idx, rng)
            acc += _irb_survival_density(k, seq, kraus, gate_kraus)
        surv_int.append(acc / n_seq)
    alpha_int, _ = fit_rb(ms, surv_int, k)
    d = 1 << k
    r_gate = (d - 1) / d * (1.0 - alpha_int / alpha_ref)
    return float(alpha_ref), float(alpha_int), float(r_gate)
