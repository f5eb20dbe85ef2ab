"""Measurement, collapse and reset on a state tensor.

Replaces the reference's measurement path (src/Qubism/StateVec.hs:104-137).
These are plain torch ops, as the JAX package's were plain XLA. Updates are
in place. Randomness comes from a seeded ``torch.Generator`` on the CPU;
every draw can be replaced by ``uniforms=`` so tests can inject the JAX
package's own draws.

Born rule: the reference samples with ``r < sqrt(p)`` (quirk, see
SURVEY.md §2.4.2). We default to the correct ``r < p``; the quirk is
available via ``config.reference_sqrt_born``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import config


def draw(gen: torch.Generator | None, k: int, uniforms=None) -> np.ndarray:
    """k float32 uniforms in [0, 1) from the CPU generator, as float64, or
    the given ``uniforms``."""
    if uniforms is not None:
        return np.asarray(uniforms, np.float64)
    return torch.rand(k, generator=gen, dtype=torch.float32).numpy().astype(np.float64)


def _halves(state: torch.Tensor, q: int, n: int) -> torch.Tensor:
    """(2^q, 2, 2^(n-1-q)) view: axis 1 is qubit q's bit."""
    return state.view(1 << q, 2, 1 << (n - 1 - q))


def prob_one(state: torch.Tensor, q: int, n: int) -> float:
    """Born probability that measuring qubit q yields 1."""
    return float(torch.linalg.vector_norm(_halves(state, q, n)[:, 1, :]) ** 2)


def collapse(state: torch.Tensor, outcome: int, q: int, n: int) -> torch.Tensor:
    """Project qubit q onto ``outcome`` (0/1) and renormalize, in place.

    Mirrors reference ``collapse`` (src/Qubism/StateVec.hs:104-114): zero the
    incompatible half, then L2-normalize. A zero-norm result (projecting onto
    an impossible outcome) stays the zero vector instead of NaNs."""
    v = _halves(state, q, n)
    v[:, 1 - int(outcome), :].zero_()
    nrm = float(torch.linalg.vector_norm(v[:, int(outcome), :]))
    if nrm > 0:
        state.mul_(1.0 / nrm)
    return state


def _threshold(p1: float) -> float:
    return math.sqrt(p1) if config.reference_sqrt_born else p1


def measure_qubit(state: torch.Tensor, gen: torch.Generator | None, q: int, n: int,
                  uniform: float | None = None) -> int:
    """Sample qubit q and collapse the state in place. Returns the bit."""
    r = draw(gen, 1)[0] if uniform is None else uniform
    outcome = int(r < _threshold(prob_one(state, q, n)))
    collapse(state, outcome, q, n)
    return outcome


def marginal_table(state: torch.Tensor, n: int, measured) -> np.ndarray:
    """|a|^2 summed over the unmeasured qubits: a (2^k,) float64 host table,
    bit order = sorted(measured), MSB = smallest qubit. Contiguous runs of
    measured / unmeasured qubits are grouped, so the view has one axis per
    run."""
    p = state.abs()
    p.mul_(p)
    runs: list[list] = []  # [log2 size, measured?]
    for q in range(n):
        keep = q in measured
        if runs and runs[-1][1] == keep:
            runs[-1][0] += 1
        else:
            runs.append([1, keep])
    view = p.view([1 << size for size, _ in runs])
    drop = [a for a, (_, keep) in enumerate(runs) if not keep]
    table = view.sum(dim=drop) if drop else view
    return table.reshape(-1).double().cpu().numpy()


def ancestral_draws(table: np.ndarray, qubits, uniforms) -> list[int]:
    """The k Born draws on a marginal table in the GIVEN qubit order, with
    the same conditional probabilities as collapse-as-you-go:
    p(b_i = 1 | b_<i) = mass(prefix, 1) / mass(prefix)."""
    k = len(qubits)
    srt = sorted(qubits)
    tidx = np.arange(1 << k, dtype=np.int64)
    mask = np.ones(1 << k)
    outcomes = []
    for i, q in enumerate(qubits):
        bit1 = ((tidx >> (k - 1 - srt.index(q))) & 1).astype(np.float64)
        masked = table * mask
        tot = masked.sum()
        p1 = (masked * bit1).sum() / tot if tot > 0 else 0.0
        o = int(uniforms[i] < _threshold(p1))
        outcomes.append(o)
        mask = mask * (bit1 if o else 1.0 - bit1)
    return outcomes


def project(state: torch.Tensor, n: int, qubits, outcomes, scale: float) -> torch.Tensor:
    """Keep only the amplitudes whose ``qubits`` read ``outcomes``, times
    ``scale``, in place: a row indicator times a column indicator over a
    (2^(n-c), 2^c) view, c = min(n, 15), so no state-sized temp is made."""
    c = min(n, 15)
    rows = np.full(1 << (n - c), scale)
    cols = np.ones(1 << c)
    ridx = np.arange(1 << (n - c), dtype=np.int64)
    cidx = np.arange(1 << c, dtype=np.int64)
    for q, o in zip(qubits, outcomes):
        pos = n - 1 - q
        if pos >= c:
            rows *= ((ridx >> (pos - c)) & 1) == o
        else:
            cols *= ((cidx >> pos) & 1) == o
    view = state.view(1 << (n - c), 1 << c)
    view.mul_(torch.from_numpy(rows.astype(np.float32)).to(state.device)[:, None])
    view.mul_(torch.from_numpy(cols.astype(np.float32)).to(state.device)[None, :])
    return state


#: above this many qubits per event the 2^k marginal table stops paying
_MEASURE_TABLE_MAX = 16


def measure_qubits(state: torch.Tensor, gen: torch.Generator | None, qubits, n: int,
                   uniforms=None) -> list[int]:
    """Measure ``qubits`` sequentially in order (collapse-as-you-go,
    reference semantics StateVec.hs:133-137) and collapse the state in
    place. Each chunk of up to 16 qubits is one marginal-table sweep, the
    ancestral draws on the host, and one projection. Returns the bits."""
    qubits = tuple(qubits)
    u = draw(gen, len(qubits), uniforms)
    if config.force_sequential_measure or len(set(qubits)) != len(qubits):
        return [measure_qubit(state, None, q, n, uniform=u[i])
                for i, q in enumerate(qubits)]
    outs: list[int] = []
    for i in range(0, len(qubits), _MEASURE_TABLE_MAX):
        chunk = qubits[i:i + _MEASURE_TABLE_MAX]
        table = marginal_table(state, n, chunk)
        o = ancestral_draws(table, chunk, u[i:i + len(chunk)])
        # the collapsed norm^2 is the table entry the outcomes select
        srt = sorted(chunk)
        mass = table[sum(o[chunk.index(q)] << (len(srt) - 1 - j) for j, q in enumerate(srt))]
        project(state, n, chunk, o, 1.0 / math.sqrt(mass) if mass > 0 else 0.0)
        outs.extend(o)
    return outs


def probabilities(state: torch.Tensor) -> torch.Tensor:
    """|psi|^2 over the computational basis, float32."""
    p = state.abs()
    return p.mul_(p)
