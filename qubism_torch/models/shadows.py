"""Classical shadows: randomized single-shot state certification.

Counterpart of qubism_tpu/models/shadows.py. The random-Pauli-basis shadow
protocol (Huang, Kueng, Preskill, Nat. Phys. 16, 1050 (2020)): each
snapshot measures EVERY qubit in an independently random X/Y/Z basis and
keeps one shot; any k-local Pauli expectation is then estimated from the
snapshot record with variance ~3^k / T, independent of how many
observables are read out — the shot-frugal complement of
:mod:`qubism_torch.models.estimation`'s grouped per-term sampling.

Engine shape: the state is prepared once by ``CompiledCircuit``; the
snapshots run in chunks of a (chunk, 2^n) batch on the state's device,
each qubit's basis rotation a 2x2 chosen per snapshot from a (3, 2, 2)
table and applied to the batch by broadcasting, then one inverse-CDF draw
per snapshot (``models.trajectories.trajectory_sample``) with uniforms from
a CPU ``torch.Generator`` seeded with ``seed``. Only the (T, n) basis and
outcome-bit records leave the device. The bases are drawn by
``np.random.default_rng(seed)``, as the JAX package draws them, so both
packages measure the same bases at a seed; the outcomes are their own
draws. Estimation is host-side numpy over the records with
median-of-means robustness.

Engine extension: the reference measures only whole registers in the Z
basis (src/Qubism/QASM/ProgState.hs measureQubit) and has no
randomized protocols.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from ..ops.fusion import CompiledCircuit

__all__ = ["shadow_snapshots", "shadow_expectation", "shadow_pauli_sum",
           "ShadowRecord"]

# basis index 0=X, 1=Y, 2=Z; rotation U_b with U_b P_b U_b^dag = Z:
# X -> H, Y -> H S^dag, Z -> I (split re/im, f32)
_ROT_RE = np.zeros((3, 2, 2), np.float32)
_ROT_IM = np.zeros((3, 2, 2), np.float32)
_s = 1.0 / math.sqrt(2.0)
_ROT_RE[0] = [[_s, _s], [_s, -_s]]                  # H
_ROT_RE[1] = [[_s, 0.0], [_s, 0.0]]                 # H S^dag (re)
_ROT_IM[1] = [[0.0, -_s], [0.0, _s]]                # H S^dag (im)
_ROT_RE[2] = np.eye(2)
_BASIS_CODE = {"X": 0, "Y": 1, "Z": 2}


class ShadowRecord:
    """The (T, n) basis-index and outcome-bit records of a shadow run."""

    def __init__(self, bases: np.ndarray, bits: np.ndarray):
        self.bases = np.asarray(bases, np.int8)
        self.bits = np.asarray(bits, np.int8)
        self.T, self.n = self.bases.shape

    def pauli_values(self, pauli: str) -> np.ndarray:
        """The (T,) per-snapshot single-shot estimator of ``<P>``: the
        product over P's support of ``3 * (-1)^bit`` where the snapshot
        basis matches P there, 0 otherwise (identity -> all-ones)."""
        if len(pauli) != self.n:
            raise ValueError(f"pauli length {len(pauli)} != n={self.n}")
        vals = np.ones(self.T, np.float64)
        for q, c in enumerate(pauli):
            if c == "I":
                continue
            if c not in _BASIS_CODE:
                raise ValueError(f"bad pauli letter {c!r}")
            match = self.bases[:, q] == _BASIS_CODE[c]
            vals *= 3.0 * (1.0 - 2.0 * self.bits[:, q]) * match
        return vals


def shadow_snapshots(prims, n: int, snapshots: int, seed: int = 0,
                     chunk: int = 256) -> ShadowRecord:
    """Run the shadow acquisition: prepare the state once, then draw
    ``snapshots`` (random basis, single shot) records, ``chunk`` snapshots
    of the state at a time."""
    import torch

    from ..ops.measure import draw
    from .trajectories import trajectory_sample

    c = CompiledCircuit(n, list(prims))
    psi = c(c.init_state())
    rot = torch.complex(torch.from_numpy(_ROT_RE), torch.from_numpy(_ROT_IM)).to(psi.device)
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 3, size=(snapshots, n)).astype(np.int32)
    gen = torch.Generator().manual_seed(int(seed))
    bits = np.empty((snapshots, n), np.int8)
    with torch.no_grad():
        for lo in range(0, snapshots, chunk):
            hi = min(lo + chunk, snapshots)
            u = rot[torch.from_numpy(bases[lo:hi]).to(device=psi.device, dtype=torch.long)]
            x = psi.expand(hi - lo, -1)
            for q in range(n):
                # the basis-selected 2x2 on qubit q: (T, 2^q, 2, 2^(n-q-1))
                v = x.reshape(hi - lo, 1 << q, 2, 1 << (n - 1 - q))
                uq = u[:, q, :, :, None, None]            # (T, 2, 2, 1, 1)
                x = torch.stack([uq[:, 0, 0] * v[:, :, 0] + uq[:, 0, 1] * v[:, :, 1],
                                 uq[:, 1, 0] * v[:, :, 0] + uq[:, 1, 1] * v[:, :, 1]], dim=2)
                x = x.reshape(hi - lo, 1 << n)
            bits[lo:hi] = trajectory_sample(x, uniforms=draw(gen, hi - lo))
            del x
    return ShadowRecord(bases, bits)


def _median_of_means(vals: np.ndarray, batches: int) -> float:
    k = max(1, min(batches, len(vals)))
    return float(np.median([b.mean() for b in np.array_split(vals, k)]))


def shadow_expectation(record: ShadowRecord, pauli: str,
                       batches: int = 10) -> float:
    """Median-of-means estimate of ``<P>`` from a shadow record."""
    return _median_of_means(record.pauli_values(pauli), batches)


def shadow_pauli_sum(record: ShadowRecord, terms: Sequence,
                     batches: int = 10, constant: float = 0.0) -> float:
    """``constant + sum_j c_j <P_j>`` from ONE shadow record — the
    many-observables regime the protocol exists for (no new shots per
    added term)."""
    total = constant
    for coef, pauli in terms:
        if set(pauli) == {"I"}:
            total += coef
        else:
            total += coef * shadow_expectation(record, pauli, batches)
    return total
