"""Mesh-sharded density matrices: exact open-system simulation past the
single-buffer cap.

Counterpart of qubism_tpu/parallel/density.py. The vectorized density
matrix is a 2n-qubit state (core/density.py), so it runs on a
:class:`~qubism_torch.parallel.sharded.ShardedSim` of 2n qubits with one
bank per shard: unitaries as (U row, conj(U) column) prim pairs through the
same fused segments and relabelling swaps, a Kraus channel as its
superoperator applied to every shard's buffer after the row and column
targets were made local, and every readout as a gather of the 2^n entries it
needs (diagonal entries and Pauli-trace pairs are tiny against the 2^(2n)
state). One process holds every shard, so a gather indexes each shard's
buffer with the entries that live there and adds them up on the host in
float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import density as _density
from ..core.gates import Prim
from ..ops import apply as _apply
from ..ops import measure as _measure
from .sharded import LOCAL_MAX, ShardedSim, _norm2

__all__ = ["ShardedDensityMatrix"]


class ShardedDensityMatrix:
    """An n-qubit mixed state rho, vectorized over a device mesh.

    Same surface as :class:`~qubism_torch.core.density.DensityMatrix`
    (``apply`` for unitary prim streams, ``apply_channel`` for Kraus maps,
    ``expectation``/``probs``/``trace``/``purity``, measurement, sampling).
    """

    def __init__(self, n: int, mesh=None, allocate: bool = True):
        self.n = n
        # validate the shape BEFORE allocating: an oversized rho would
        # otherwise try to allocate its buffers before the error below
        self.sim = ShardedSim(2 * n, mesh, banks=0, allocate=False)
        if self.sim.m > LOCAL_MAX:
            raise ValueError(
                f"per-device block of {self.sim.m} qubits (n={n} over "
                f"{self.sim.D} shards) exceeds the single-buffer limit "
                f"{LOCAL_MAX}; use a larger mesh")
        if allocate:
            self.sim.reset_state()

    # -- evolution ----------------------------------------------------------

    def apply(self, prims) -> "ShardedDensityMatrix":
        """Unitary prims: U on row qubits, conj(U) on column qubits, the
        whole doubled stream through the sharded engine's fused segments."""
        if isinstance(prims, Prim):
            prims = [prims]
        stream = []
        for p in prims:
            u = np.asarray(p.u, dtype=np.complex128)
            stream.append(Prim(u, tuple(p.targets), p.diag))
            stream.append(Prim(np.conj(u), tuple(t + self.n for t in p.targets), p.diag))
        self.sim.apply(stream)
        return self

    def apply_channel(self, kraus, targets) -> "ShardedDensityMatrix":
        """rho -> sum_i K_i rho K_i^dag: make the row and column targets
        local, then one pass of the channel's superoperator over every
        shard's buffer."""
        if isinstance(targets, int):
            targets = (targets,)
        row = tuple(int(t) for t in targets)
        col = tuple(t + self.n for t in row)
        sim = self.sim
        local = tuple(p - sim.d for p in sim.localize(row + col))
        s = _density.superoperator(kraus)
        for _, _, t in sim._each():
            _apply.apply_gate(t, s, local, sim.m)
        sim.dispatch_count += 1
        return self

    def _project(self, q: int, outcome: int):
        """Keep the block of rho whose row and column qubit q read
        ``outcome`` (two diagonal prims: no exchange on any bit) and
        renormalize by the trace; a zero trace leaves the zero matrix."""
        proj = np.array([1.0 - outcome, float(outcome)], dtype=complex)
        self.sim.apply([Prim(proj, (q,), diag=True), Prim(proj, (q + self.n,), diag=True)])
        tr = self.trace()
        self._scale(0.0 if tr == 0 else 1.0 / tr)

    def reset(self, q: int) -> "ShardedDensityMatrix":
        """Projection to |0> and renormalization by the trace (reference
        reset semantics, src/Qubism/QASM/Simulation.hs:146-156)."""
        self._project(q, 0)
        return self

    def _scale(self, s: float):
        for _, _, t in self.sim._each():
            t.mul_(s)

    # -- gathers (diagonal / Pauli-trace entries are 2^n amplitudes) ---------

    def _gather(self, logical: np.ndarray) -> np.ndarray:
        """The amplitudes at the flat LOGICAL indices ``logical`` (int64,
        over 2n qubits) as host complex128, under the sim's current
        relabelling."""
        sim = self.sim
        n2 = 2 * self.n
        if sim.perm == list(range(n2)):
            phys = logical
        else:
            phys = np.zeros_like(logical)
            for lq in range(n2):
                phys |= ((logical >> (n2 - 1 - lq)) & 1) << (n2 - 1 - sim.perm[lq])
        shard = phys >> sim.m
        loc = phys & ((1 << sim.m) - 1)
        out = np.zeros(logical.shape, dtype=np.complex128)
        for i, _, t in sim._each():
            sel = np.nonzero(shard == i)[0]
            if sel.size:
                vals = t[torch.from_numpy(loc[sel]).to(t.device)]
                out[sel] = torch.view_as_real(vals).double().cpu().numpy().view(np.complex128)[:, 0]
        return out

    # -- readout --------------------------------------------------------------

    def probs(self) -> np.ndarray:
        """(2^n,) computational-basis probabilities (the diagonal)."""
        ys = np.arange(1 << self.n, dtype=np.int64)
        return self._gather((ys << self.n) | ys).real.copy()

    def trace(self) -> float:
        return float(self.probs().sum())

    def purity(self) -> float:
        """Tr(rho^2) = the vectorized norm squared, summed over the shards."""
        return sum(_norm2(t) for _, _, t in self.sim._each())

    def expectation(self, pauli: str) -> float:
        """Tr(P rho) = i^{#Y} sum_x s(x) rho[x, x ^ f]: one gather of the
        2^n (row, flipped column) entries."""
        pauli = _measure._check_pauli(pauli, self.n)
        idx, signs, n_y = _density.pauli_trace_entries(pauli, self.n)
        s = (self._gather(idx) * signs).sum()
        return float(_measure._apply_iy(s.real, s.imag, n_y).real)

    def expectation_sum(self, terms) -> float:
        return float(sum(c * self.expectation(p) for c, p in terms))

    def prob_one(self, q: int) -> float:
        return _density.prob_one_of(self.probs(), self.n, q)

    def measure_qubit(self, q: int, gen: torch.Generator | None = None,
                      uniform: float | None = None) -> int:
        """Sample qubit q, project rho, renormalize by the trace: the
        contract of :meth:`DensityMatrix.measure_qubit`. Returns the
        outcome."""
        outcome = _density.born_outcome(self.prob_one(q), gen, uniform)
        self._project(q, outcome)
        return outcome

    def sample(self, shots: int, gen: torch.Generator | None = None) -> dict[str, int]:
        """Non-destructive shot sampling from the diagonal (the contract of
        :meth:`DensityMatrix.sample`)."""
        return _density.sample_diagonal(self.probs(), self.n, shots, gen)
