"""Quantum volume (QV) model circuits and the heavy-output protocol.

Counterpart of qubism_tpu/models/qv.py. The ideal distribution is one
``CompiledCircuit`` run through the kernels (each SU(4) block one dense
2-qubit pass); noisy heavy masses come from the port's ``DensityMatrix`` or
its trajectory engine (``run_trajectories``).

Cross et al., "Validating quantum computers using randomized model
circuits" (2019): a width-m QV circuit is m layers, each a uniformly random
qubit permutation followed by Haar-random SU(4) blocks on the paired
qubits.  A run PASSES width m (quantum volume 2^m) when the mean
heavy-output probability (the chance a sampled bitstring lands in the
heavier-than-median half of the IDEAL output distribution) clears 2/3 with
two-sigma confidence; the noiseless ideal converges to (1 + ln 2)/2 ~ 0.85
and a fully depolarized device gives exactly 1/2.

Engine shape: permutations are free (target relabeling — the simulator
never moves amplitudes for a layer permutation), each SU(4) block is one
dense 2-qubit prim for the fused engine, the ideal distribution is one
compiled run, and noisy heavy masses come from the exact DensityMatrix
engine (small m) or the MCWF trajectory engine with a 2q-depolarizing
ChannelOp after every block — the same channel spec as the ``--noise``
CLI path.

Engine extension: the reference has no randomized-benchmark protocols and
no noise model (src/Qubism/StateVec.hs is pure states only)."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..core.gates import Prim
from ..ops.fusion import CompiledCircuit

_MAX_M = 16  # exact ideal distribution: demo scale


def haar_su4(rng: np.random.Generator) -> np.ndarray:
    """Haar-random SU(4) via QR of a complex Ginibre matrix (phases of R's
    diagonal folded in; determinant normalized away)."""
    z = (rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4)))
    q, r = np.linalg.qr(z)
    d = np.diagonal(r)
    q = q * (d / np.abs(d))
    det = np.linalg.det(q)
    return q / det ** 0.25


def qv_prims(m: int, rng: np.random.Generator) -> list[Prim]:
    """One width-m QV model circuit: m layers of (random permutation,
    Haar-SU(4) on pairs).  Permutations cost nothing — they relabel the
    block targets instead of moving amplitudes."""
    if not 2 <= m <= _MAX_M:
        raise ValueError(f"qv_prims: 2 <= m <= {_MAX_M}")
    prims: list[Prim] = []
    for _ in range(m):
        perm = rng.permutation(m)
        for i in range(m // 2):
            a, b = int(perm[2 * i]), int(perm[2 * i + 1])
            prims.append(Prim(haar_su4(rng), (a, b)))
    return prims


def ideal_probs(prims, m: int) -> np.ndarray:
    c = CompiledCircuit(m, list(prims))
    amps = c.state_to_complex(c(c.init_state()))
    p = np.abs(amps) ** 2
    return p / p.sum()


def heavy_set(probs: np.ndarray) -> np.ndarray:
    """Indices of outputs strictly heavier than the median ideal
    probability (the paper's definition)."""
    return np.nonzero(probs > np.median(probs))[0]


def heavy_mass(output_probs: np.ndarray, heavy: np.ndarray) -> float:
    """Probability that a sample from ``output_probs`` is heavy."""
    return float(output_probs[heavy].sum())


def _noisy_probs_density(prims, m: int, kraus2) -> np.ndarray:
    from ..core.density import DensityMatrix

    rho = DensityMatrix(m)
    for p in prims:
        rho = rho.apply([p])
        if kraus2 is not None:
            rho = rho.apply_channel(kraus2, p.targets)
    return rho.probs()


def _noisy_probs_trajectories(prims, m: int, kraus2, ntraj: int,
                              seed: int) -> np.ndarray:
    from .trajectories import ChannelOp, run_trajectories, trajectory_probs

    program = []
    for p in prims:
        program.append(p)
        if kraus2 is not None:
            program.append(ChannelOp(kraus2, p.targets))
    planes = run_trajectories(m, program, ntraj=ntraj, seed=seed)
    return trajectory_probs(planes)


@dataclass(frozen=True)
class QVResult:
    m: int
    n_circuits: int
    shots: int | None             # None = exact heavy masses, no shot noise
    hop_mean: float               # mean heavy-output probability
    hop_sigma: float              # binomial/bootstrap sigma of the mean
    passed: bool                  # hop_mean - 2 sigma > 2/3
    quantum_volume: int           # 2^m if passed else 0
    hops: tuple[float, ...]


def qv_experiment(m: int, n_circuits: int = 20, shots: int | None = None,
                  seed: int = 0, kraus2=None, executor: str = "density",
                  ntraj: int = 512) -> QVResult:
    """Run the width-m QV protocol.  ``kraus2`` (e.g.
    core.density.depolarizing2(p)) is applied after every SU(4) block;
    None runs the noiseless device.  ``shots=None`` scores exact heavy
    masses (no sampling noise); an integer draws per-circuit binomial
    counts like hardware would."""
    rng = np.random.default_rng(seed)
    # separate generator for the binomial shot draws: sharing rng would make
    # shots=None and shots=N at the same seed execute DIFFERENT circuits,
    # breaking exact-vs-sampled comparisons at a fixed seed
    shot_rng = np.random.default_rng(seed + 1)
    hops = []
    for k in range(n_circuits):
        prims = qv_prims(m, rng)
        heavy = heavy_set(ideal_probs(prims, m))
        if kraus2 is None:
            out = ideal_probs(prims, m)
        elif executor == "density":
            out = _noisy_probs_density(prims, m, kraus2)
        elif executor == "trajectories":
            out = _noisy_probs_trajectories(prims, m, kraus2, ntraj,
                                            seed * 6151 + k)
        else:
            raise ValueError(f"unknown executor {executor!r}")
        h = heavy_mass(out, heavy)
        if shots is not None:
            h = shot_rng.binomial(shots, min(max(h, 0.0), 1.0)) / shots
        hops.append(h)
    hops_arr = np.asarray(hops, dtype=np.float64)
    mean = float(hops_arr.mean())
    if n_circuits > 1:
        sigma = float(hops_arr.std(ddof=1) / math.sqrt(n_circuits))
    else:  # pragma: no cover - degenerate config
        sigma = float("inf")
    passed = mean - 2 * sigma > 2.0 / 3.0
    return QVResult(m=m, n_circuits=n_circuits, shots=shots, hop_mean=mean,
                    hop_sigma=sigma, passed=bool(passed),
                    quantum_volume=(1 << m) if passed else 0,
                    hops=tuple(float(h) for h in hops))


def measured_quantum_volume(max_m: int = 5, kraus2=None, n_circuits: int = 20,
                            seed: int = 0, **kw) -> int:
    """Largest passing 2^m over widths 2..max_m (the device's quantum
    volume under the given noise)."""
    best = 0
    for m in range(2, max_m + 1):
        res = qv_experiment(m, n_circuits=n_circuits, seed=seed,
                            kraus2=kraus2, **kw)
        if res.passed:
            best = res.quantum_volume
    return best
