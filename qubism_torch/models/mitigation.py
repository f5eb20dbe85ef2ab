"""Error mitigation: zero-noise extrapolation and readout-error inversion.

Counterpart of qubism_tpu/models/mitigation.py, run on the port's
``DensityMatrix`` and trajectory engine (``run_trajectories``).

ZNE (Temme/Li-Benjamin 2017, Kandala et al. 2019): re-run the circuit at
amplified noise and extrapolate the observable to the zero-noise limit.
Noise is amplified by **global unitary folding** — the prim stream becomes
C (C^dag C)^((s-1)/2) for odd scale s, a noiseless identity that multiplies
the per-gate error count by s — exactly what hardware ZNE does, and exactly
representable here because the noisy executors attach channels per gate.
Extrapolators: Richardson (exact polynomial through all points), linear
least squares, and a 2-parameter exponential a*b^s fit (closed form from 3
geometric scale points), which is EXACT for purely depolarizing noise on a
Pauli observable.

Readout mitigation: the engine's `ro:p` assignment error is a per-qubit
binary symmetric channel, so the full confusion matrix is a Kronecker
product A = kron_i [[1-p,p],[p,1-p]] and its inverse factorizes per qubit.
`mitigate_counts` applies the tensored inverse to an empirical
distribution; `mitigate_z_expectation` uses the scalar form
<Z>_true = <Z>_meas / (1-2p)^w for a weight-w Z string.

Engine extension: the reference has no noise model, so nothing to mitigate
(src/Qubism/StateVec.hs)."""

from __future__ import annotations

import math

import numpy as np

from ..core.density import DensityMatrix
from ..core.gates import Prim
from .amplitude import invert_prims


def fold_prims(prims, scale: int) -> list[Prim]:
    """Global unitary folding: C (C^dag C)^((scale-1)/2) for odd scale >= 1.
    Noiselessly the identity-padded circuit; under per-gate noise the error
    count scales by ``scale``."""
    scale = int(scale)
    if scale < 1 or scale % 2 == 0:
        raise ValueError("fold scale must be an odd integer >= 1")
    prims = list(prims)
    out = list(prims)
    inv = invert_prims(prims)
    for _ in range((scale - 1) // 2):
        out += inv + prims
    return out


def _check_noise_placement(prims, kraus1, kraus2):
    """Noise attaches only to 1- and 2-target prims; a wider prim (e.g. an
    amplitude.py whole-register reflection) would silently stay noiseless —
    folding would then not amplify it and the extrapolation would mitigate
    a different noise model than intended. Refuse loudly."""
    if kraus1 is None and kraus2 is None:
        return
    for p in prims:
        if len(p.targets) > 2:
            raise ValueError(
                f"zne_expectation: prim with {len(p.targets)} targets has no "
                "noise placement (kraus1/kraus2 cover 1q/2q gates only); "
                "decompose it into 1q/2q prims or run it noiseless "
                "explicitly with kraus1=kraus2=None")


def _noisy_expectation_density(prims, n: int, pauli: str, kraus1, kraus2):
    rho = DensityMatrix(n)
    for p in prims:
        rho = rho.apply([p])
        k = len(p.targets)
        if k == 1 and kraus1 is not None:
            rho = rho.apply_channel(kraus1, p.targets)
        elif k == 2 and kraus2 is not None:
            rho = rho.apply_channel(kraus2, p.targets)
    return float(rho.expectation(pauli))


def _noisy_expectation_trajectories(prims, n: int, pauli: str, kraus1,
                                    kraus2, ntraj: int, seed: int):
    from .trajectories import (ChannelOp, run_trajectories,
                               trajectory_expectation)

    program = []
    for p in prims:
        program.append(p)
        k = len(p.targets)
        if k == 1 and kraus1 is not None:
            program.append(ChannelOp(kraus1, p.targets))
        elif k == 2 and kraus2 is not None:
            program.append(ChannelOp(kraus2, p.targets))
    planes = run_trajectories(n, program, ntraj=ntraj, seed=seed)
    return float(trajectory_expectation(planes, pauli, n)[0])


def richardson_extrapolate(scales, values) -> float:
    """Exact-polynomial (Lagrange at 0) extrapolation through all points."""
    scales = np.asarray(scales, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    est = 0.0
    for i, (si, vi) in enumerate(zip(scales, values)):
        w = 1.0
        for j, sj in enumerate(scales):
            if j != i:
                w *= sj / (sj - si)
        est += w * vi
    return float(est)


def linear_extrapolate(scales, values) -> float:
    b, a = np.polyfit(np.asarray(scales, float), np.asarray(values, float), 1)
    return float(a)


def exp_extrapolate(scales, values) -> float:
    """Fit E(s) = a * b^s on three geometric scales (s, cs, c^2 s): then
    b^((c-1)s) = (v2-v1)/(v1-v0) ... here we use the standard closed form
    for EQUALLY-SPACED scales s0, s0+d, s0+2d:
        ratio = (v2 - v1)/(v1 - v0) = b^d,  a*b^s0 = v0 + (v1-v0)/(ratio-1) ...
    Exact when the observable decays geometrically in the fold scale (pure
    depolarizing channels on a Pauli observable).  Falls back to linear when
    the ratio is degenerate."""
    s = np.asarray(scales, dtype=np.float64)
    v = np.asarray(values, dtype=np.float64)
    if len(s) < 3 or abs((s[1] - s[0]) - (s[2] - s[1])) > 1e-9:
        raise ValueError("exp_extrapolate needs >=3 equally spaced scales")
    d0, d1 = v[1] - v[0], v[2] - v[1]
    if abs(d0) < 1e-15 or abs(d1 / d0 - 1.0) < 1e-12:
        return linear_extrapolate(s, v)
    ratio = d1 / d0                       # = b^step
    if ratio <= 0:
        return linear_extrapolate(s, v)
    step = s[1] - s[0]
    b = ratio ** (1.0 / step)
    a = d0 / (b ** s[0] * (b ** step - 1.0))
    # E(s) = c + a b^s with c the noise floor; at zero noise the floor is
    # part of the signal only if b -> the observable's asymptote is c.
    c = v[0] - a * b ** s[0]
    return float(c + a)                   # E(0) = c + a * b^0


def zne_expectation(prims, n: int, pauli: str, kraus1=None, kraus2=None,
                    scales=(1, 3, 5), method: str = "richardson",
                    executor: str = "density", ntraj: int = 1024,
                    seed: int = 0):
    """Zero-noise-extrapolated <pauli>.  Returns (estimate, raw_values)
    where raw_values are the measured expectations at each fold scale.

    Noise placement: ``kraus1``/``kraus2`` attach after every 1-/2-target
    prim respectively; prims with more than 2 targets are rejected when
    noise is set (they would stay silently noiseless and break the
    fold-amplification premise — decompose them first)."""
    _check_noise_placement(prims, kraus1, kraus2)
    vals = []
    for i, s in enumerate(scales):
        folded = fold_prims(prims, s)
        if executor == "density":
            v = _noisy_expectation_density(folded, n, pauli, kraus1, kraus2)
        elif executor == "trajectories":
            v = _noisy_expectation_trajectories(folded, n, pauli, kraus1,
                                                kraus2, ntraj,
                                                seed * 4241 + i)
        else:
            raise ValueError(f"unknown executor {executor!r}")
        vals.append(v)
    if method == "richardson":
        est = richardson_extrapolate(scales, vals)
    elif method == "linear":
        est = linear_extrapolate(scales, vals)
    elif method == "exp":
        est = exp_extrapolate(scales, vals)
    else:
        raise ValueError(f"unknown method {method!r}")
    return est, vals


# -- readout mitigation ----------------------------------------------------------


def confusion_matrix(n: int, p: float) -> np.ndarray:
    """Full 2^n x 2^n assignment matrix for iid per-qubit flip prob p."""
    a1 = np.array([[1 - p, p], [p, 1 - p]], dtype=np.float64)
    a = np.array([[1.0]])
    for _ in range(n):
        a = np.kron(a, a1)
    return a


def mitigate_counts(counts: dict[str, int], p: float) -> dict[str, float]:
    """Invert the per-qubit readout channel on an empirical distribution:
    returns quasi-probabilities (may dip slightly negative from sampling
    noise) keyed by the same big-endian bitstrings."""
    if not counts:
        return {}
    n = len(next(iter(counts)))
    if abs(1 - 2 * p) < 1e-12:
        raise ValueError("p = 0.5 readout noise is not invertible")
    total = sum(counts.values())
    vec = np.zeros(1 << n, dtype=np.float64)
    for bits, c in counts.items():
        vec[int(bits, 2)] = c / total
    inv1 = np.array([[1 - p, -p], [-p, 1 - p]], dtype=np.float64) / (1 - 2 * p)
    # apply the tensored inverse one qubit axis at a time: O(n 2^n)
    t = vec.reshape((2,) * n)
    for q in range(n):
        t = np.tensordot(inv1, np.moveaxis(t, q, 0), axes=([1], [0]))
        t = np.moveaxis(t, 0, q)
    out = t.reshape(-1)
    return {format(i, f"0{n}b"): float(out[i]) for i in range(1 << n)
            if abs(out[i]) > 1e-15}


def mitigate_z_expectation(meas: float, p: float, weight: int = 1) -> float:
    """<Z...Z>_true = <Z...Z>_meas / (1-2p)^weight for iid readout flips."""
    return float(meas / (1 - 2 * p) ** weight)
