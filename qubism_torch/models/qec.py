"""QEC memory experiments on the Pauli-frame executor.

Counterpart of qubism_tpu/models/qec.py: r rounds of repetition-code
syndrome extraction (CX fan-in to ancillas, measure, reset) under
phenomenological noise, every trajectory a Pauli frame, the whole
experiment one layered frame scan (stabilizer/frames.py:
frame_run_vals_events), decoded by majority vote.

Noise model: **phenomenological bit-flip** — before every round each data
qubit flips with probability p (explicit identity prims mark the error
locations; ``noise_identity_only`` keeps the syndrome-extraction CXs
noiseless), and syndrome measurement is perfect. The repetition code then
has a closed-form logical error rate (:func:`repetition_logical_rate`),
which pins the executor end to end.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.gates import Prim
from ..run.compiler import EvGates, EvMeasure, EvReset

__all__ = ["repetition_memory", "repetition_logical_rate", "RepetitionMemoryResult"]

_I2 = np.eye(2, dtype=np.complex128)
_CX = np.eye(4, dtype=np.complex128)[[0, 1, 3, 2]]


class _FrameProg:
    """The minimal program surface ``frame_run_vals_events`` reads."""

    def __init__(self, n, cdfs, creg_sizes):
        self.n = n
        self.cdfs = cdfs
        self.cdfs2 = np.zeros((0, 16), np.float32)
        self.creg_names = sorted(creg_sizes)
        self.creg_sizes = creg_sizes
        self.readout_p = None
        self.noise_identity_only = True


class RepetitionMemoryResult:
    """Outcome record of :func:`repetition_memory`: ``syndromes[k]`` the
    (ntraj, d-1) round-k syndromes, ``data`` the (ntraj, d) final data
    readout, ``logical_errors`` the per-trajectory majority-vote verdicts,
    ``logical_rate`` their mean, ``analytic`` the closed-form rate, and
    ``syndrome_consistent`` whether the last round's syndrome equals the
    parity of adjacent final data bits in EVERY trajectory (extraction is
    noiseless, so a wrong frame propagation cannot pass it by luck)."""

    def __init__(self, d, rounds, p, syndromes, data):
        self.d = d
        self.rounds = rounds
        self.p = p
        self.syndromes = syndromes
        self.data = data
        # with perfect syndrome measurement majority(data) IS the
        # minimum-weight decode
        self.logical_errors = data.sum(axis=1) > d // 2
        self.logical_rate = float(self.logical_errors.mean())
        self.analytic = repetition_logical_rate(d, rounds, p)
        want = (data[:, :-1] ^ data[:, 1:]).astype(np.int32)
        self.syndrome_consistent = bool((syndromes[-1] == want).all())


def repetition_logical_rate(d: int, rounds: int, p: float) -> float:
    """Closed-form logical error rate of the distance-d repetition code
    after ``rounds`` rounds of per-qubit bit-flip probability p, perfect
    syndrome measurement and majority vote: each data qubit flips in total
    with ``q = (1 - (1-2p)^r) / 2`` (independently), and the decoder errs
    iff more than (d-1)/2 of them did — a binomial tail."""
    q = (1.0 - (1.0 - 2.0 * p) ** rounds) / 2.0
    return float(sum(math.comb(d, k) * q ** k * (1 - q) ** (d - k)
                     for k in range(d // 2 + 1, d + 1)))


def repetition_memory(d: int, rounds: int, p: float, ntraj: int,
                      seed: int = 0) -> RepetitionMemoryResult:
    """A distance-d repetition-code memory: data qubits 0..d-1 (|0..0>),
    ancillas d..2d-2; per round an identity row on every data qubit carries
    bf(p), two disjoint CX layers extract the d-1 parities, the ancillas are
    measured (creg ``s{k}``) and reset; a final data measurement (creg
    ``m``) closes it. 2d-1 qubits, one frame scan for all ``ntraj``
    trajectories, its random streams from generators seeded with ``seed``."""
    from ..stabilizer.frames import frame_run_vals_events

    if d < 3 or d % 2 == 0:
        raise ValueError("repetition_memory wants odd d >= 3")
    if rounds < 1:
        raise ValueError("rounds must be >= 1")
    n = 2 * d - 1
    anc = tuple(range(d, n))
    events = []
    creg_sizes = {}
    for k in range(rounds):
        events.append(EvGates(tuple(Prim(_I2, (q,)) for q in range(d))))
        events.append(EvGates(tuple(Prim(_CX, (i, d + i)) for i in range(d - 1))))
        events.append(EvGates(tuple(Prim(_CX, (i + 1, d + i)) for i in range(d - 1))))
        name = f"s{k}"
        creg_sizes[name] = d - 1
        events.append(EvMeasure(anc, ((name, None, d - 1),)))
        events.append(EvReset(anc))
    creg_sizes["m"] = d
    events.append(EvMeasure(tuple(range(d)), (("m", None, d),)))

    probs = np.cumsum(np.asarray([1 - p, p, 0.0, 0.0], np.float32))
    prog = _FrameProg(n, probs.reshape(1, 4), creg_sizes)
    vals = frame_run_vals_events(prog, events, ntraj, seed)
    syndromes = [np.asarray(vals[f"s{k}"]) for k in range(rounds)]
    return RepetitionMemoryResult(d, rounds, p, syndromes, np.asarray(vals["m"]))
