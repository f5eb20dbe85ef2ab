"""Mixed states: density matrices and noise channels on the same engine.

Counterpart of qubism_tpu/core/density.py. An n-qubit density matrix
rho_{r,c} is stored vectorized: ONE complex64 tensor of 2^(2n) amplitudes
with the ROW index in the top n qubits, the layout
:func:`qubism_torch.ops.apply.tensor` gives psi (x) conj(psi). Then

* a unitary U on qubits T maps rho -> U rho U^dag: U on the row qubits T and
  conj(U) on the column qubits T + n, two passes of the ordinary appliers
  (the gate, lane and diag kernels on a CUDA tensor);
* a Kraus channel sum_i K_i rho K_i^dag is one linear map, the superoperator
  S = sum_i K_i (x) conj(K_i) on the targets (T, T + n): a dense gate on 2
  qubits (a 1-qubit channel) or 4 (``depolarizing2``), which the gate kernel
  applies in one pass (it needs no unitarity);
* so a run of unitaries and channels on at most two qubits S is one linear
  map too, U (x) conj(U) and each channel's S multiplied out on (S, S + n):
  :meth:`DensityMatrix.apply_superoperator` applies it in one pass of the
  gate kernel. ``run.noisy.DensityProgram`` groups the gates between two
  barriers (a measurement, reset, conditional, dump or wider gate) into
  such runs (``run.noisy.group_runs``): a gate joins the latest run on its
  qubits where the run stays on two qubits, and a single-qubit gate waits
  for its qubit's next run, so a cz's pass takes the 1-qubit gates around
  it. That is exact because a gate and its channels move only past gates
  and channels on other qubits, which commute with them: every qubit's
  gates keep their program order;
* Tr(P rho) reads the 2^n entries rho[x, x ^ f]; probabilities are the
  diagonal; the purity Tr(rho^2) is the squared norm of the tensor.

Both packages keep the row index in the top n qubits, so
``ops.apply.state_from_planes`` / ``planes_from_state`` carry a rho across
unchanged.

Memory is 8 * 4^n bytes of complex64: 2 GiB at n = 14, the widest rho
:class:`~qubism_torch.run.noisy.DensityProgram` keeps in one buffer on the
CPU (as the JAX package does on one device). On a CUDA card the cap follows
the card (``run.noisy.single_buffer_cap``): an 80 GB H100 holds n = 15 (8
GiB) and n = 16 (32 GiB) in one buffer. The mesh path's shards
(parallel/density.py) lift the cap; one card's shards exist only on the CPU.

The engine's work is traced as the spans ``qubism.density.unitary`` (the
row and column passes of :meth:`DensityMatrix.apply`, and a composed run,
built and applied, which the caller opens around
:meth:`DensityMatrix.apply_superoperator`), ``qubism.density.channel`` (a
channel's superoperator, built and applied) and ``qubism.density.readout``
(the diagonal, the trace, shots and mid-circuit measurement), and counted
one per pass over rho (``utils.profiling``): ``rho_unitary_passes`` and
``rho_channel_passes`` for the passes of :meth:`DensityMatrix.apply` and
:meth:`DensityMatrix.apply_channel`, ``rho_fused_passes`` for those of
:meth:`DensityMatrix.apply_superoperator`, beside ``rho_fused_prims``, the
gates composed into them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import config
from ..ops import apply as A
from ..ops import measure as _measure
from ..utils import profiling
from .gates import Prim

#: amplitudes per partial norm of :meth:`DensityMatrix.purity` (each partial
#: is float32, their squares are added in float64; no state-sized temporary)
_NORM_CHUNK = 1 << 20

# ---------------------------------------------------------------------------
# Standard Kraus channels
# ---------------------------------------------------------------------------


def depolarizing(p: float) -> list[np.ndarray]:
    """With probability p, replace the qubit state by the maximally mixed
    state: K = {sqrt(1-p) I, sqrt(p/3) X, sqrt(p/3) Y, sqrt(p/3) Z}."""
    s = math.sqrt(p / 3.0)
    return [math.sqrt(1.0 - p) * np.eye(2, dtype=complex),
            s * np.array([[0, 1], [1, 0]], dtype=complex),
            s * np.array([[0, -1j], [1j, 0]], dtype=complex),
            s * np.array([[1, 0], [0, -1]], dtype=complex)]


def depolarizing2(p: float) -> list[np.ndarray]:
    """Two-qubit depolarizing: with probability p, replace the PAIR by the
    maximally mixed state: K = {sqrt(1-p) I4} and sqrt(p/15) Pa x Pb for
    the 15 non-identity Pauli pairs."""
    paulis = [np.eye(2, dtype=complex),
              np.array([[0, 1], [1, 0]], dtype=complex),
              np.array([[0, -1j], [1j, 0]], dtype=complex),
              np.diag([1.0, -1.0]).astype(complex)]
    s = math.sqrt(p / 15.0)
    ks = [math.sqrt(1.0 - p) * np.eye(4, dtype=complex)]
    for a in range(4):
        for b in range(4):
            if a == 0 and b == 0:
                continue
            ks.append(s * np.kron(paulis[a], paulis[b]))
    return ks


def amplitude_damping(gamma: float) -> list[np.ndarray]:
    """|1> decays to |0> with probability gamma (T1 noise)."""
    return [np.array([[1, 0], [0, math.sqrt(1.0 - gamma)]], dtype=complex),
            np.array([[0, math.sqrt(gamma)], [0, 0]], dtype=complex)]


def phase_damping(gamma: float) -> list[np.ndarray]:
    """Pure dephasing (T2 noise): off-diagonals shrink by sqrt(1-gamma)."""
    return [np.array([[1, 0], [0, math.sqrt(1.0 - gamma)]], dtype=complex),
            np.array([[0, 0], [0, math.sqrt(gamma)]], dtype=complex)]


def bit_flip(p: float) -> list[np.ndarray]:
    return [math.sqrt(1.0 - p) * np.eye(2, dtype=complex),
            math.sqrt(p) * np.array([[0, 1], [1, 0]], dtype=complex)]


def phase_flip(p: float) -> list[np.ndarray]:
    return [math.sqrt(1.0 - p) * np.eye(2, dtype=complex),
            math.sqrt(p) * np.array([[1, 0], [0, -1]], dtype=complex)]


def superoperator(kraus) -> np.ndarray:
    """S = sum_i K_i (x) conj(K_i): the channel as one (4^k, 4^k) matrix on
    the vectorized rho, row targets first (the index's high bits)."""
    ks = [np.asarray(k, dtype=np.complex128) for k in kraus]
    return sum(np.kron(k, np.conj(k)) for k in ks)


# ---------------------------------------------------------------------------
# Readouts shared with the mesh-sharded rho
# ---------------------------------------------------------------------------


def pauli_trace_entries(pauli: str, n: int):
    """Tr(P rho) = i^{#Y} sum_x s(x) rho[x, x ^ f]: (flat indices
    (x << n) | (x ^ f) of the 2^n entries, their signs s(x), #Y), for a
    checked Pauli string."""
    f, z, n_y = _measure.pauli_masks(pauli)
    xs = np.arange(1 << n, dtype=np.int64)
    return (xs << n) | (xs ^ f), _measure._parity_sign(xs, z), n_y


def sample_diagonal(probs: np.ndarray, n: int, shots: int,
                    gen: torch.Generator | None) -> dict[str, int]:
    """``shots`` basis states drawn from a rho's diagonal by a numpy
    generator whose seed is drawn from ``gen`` (seed 0 when None):
    {big-endian bitstring: count}."""
    if gen is None:
        gen = torch.Generator().manual_seed(0)
    p = np.clip(np.asarray(probs, dtype=np.float64), 0.0, None)
    p /= p.sum()
    seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
    idx = np.random.default_rng(seed).choice(p.size, size=shots, p=p)
    vals, counts = np.unique(idx, return_counts=True)
    return {format(int(v), f"0{n}b"): int(c) for v, c in zip(vals, counts)}


def prob_one_of(probs: np.ndarray, n: int, q: int) -> float:
    """The mass of a diagonal on the basis states whose qubit q reads 1."""
    idx = np.arange(1 << n)
    return float(probs[((idx >> (n - 1 - q)) & 1) == 1].sum())


def born_outcome(p1: float, gen: torch.Generator | None, uniform: float | None) -> int:
    """One Born draw (honouring ``config.reference_sqrt_born`` like the
    pure-state engines) from ``uniform`` or one float32 uniform of ``gen``."""
    thr = math.sqrt(max(p1, 0.0)) if config.reference_sqrt_born else p1
    r = _measure.draw(gen, 1)[0] if uniform is None else uniform
    return int(r < thr)


class DensityMatrix:
    """An n-qubit mixed state rho, stored vectorized on the engine; updated
    in place.

    Supports what the pure-state path does (gates as :class:`Prim` streams,
    measurement, Pauli expectations) plus Kraus noise channels.
    """

    def __init__(self, n: int, state: torch.Tensor | None = None):
        self.n = n
        self.state = A.zero_state(2 * n) if state is None else state.reshape(-1)

    @classmethod
    def from_statevec(cls, sv) -> "DensityMatrix":
        """|psi><psi| from a StateVec or a flat state tensor."""
        psi = getattr(sv, "state", sv).reshape(-1)
        n = psi.numel().bit_length() - 1
        return cls(n, A.tensor(psi, psi.conj()))

    def matrix(self) -> np.ndarray:
        """Host-side dense (2^n, 2^n) complex rho (tests / small n)."""
        if self.n > 12:
            raise ValueError("matrix() materializes 4^n entries; n > 12 "
                             "refused — use probs()/expectation() instead")
        d = 1 << self.n
        return A.complex_from_state(self.state).reshape(d, d)

    # -- evolution ----------------------------------------------------------

    def apply(self, prims) -> "DensityMatrix":
        """Apply unitary prims: U on the row qubits, conj(U) on the column
        qubits (they commute)."""
        if isinstance(prims, Prim):
            prims = [prims]
        n2 = 2 * self.n
        with profiling.span("qubism.density.unitary"):
            for p in prims:
                row = tuple(p.targets)
                col = tuple(t + self.n for t in p.targets)
                u = np.asarray(p.u, dtype=np.complex128)
                if p.diag:
                    A.apply_diag(self.state, u, row, n2)
                    A.apply_diag(self.state, np.conj(u), col, n2)
                else:
                    A.apply_gate(self.state, u, row, n2)
                    A.apply_gate(self.state, np.conj(u), col, n2)
                profiling.count("rho_unitary_passes", 2)
        return self

    def _channel_targets(self, targets):
        if isinstance(targets, int):
            targets = (targets,)
        row = tuple(int(t) for t in targets)
        return row, tuple(t + self.n for t in row)

    def apply_channel(self, kraus, targets) -> "DensityMatrix":
        """rho -> sum_i K_i rho K_i^dag for Kraus operators on ``targets``
        (a qubit index or tuple; each K_i a (2^k, 2^k) matrix), as one pass
        of the channel's :func:`superoperator`."""
        with profiling.span("qubism.density.channel"):
            row, col = self._channel_targets(targets)
            A.apply_gate(self.state, superoperator(kraus), row + col, 2 * self.n)
            profiling.count("rho_channel_passes")
        return self

    def apply_superoperator(self, s, qubits, prims: int = 1) -> "DensityMatrix":
        """One pass of the host superoperator ``s`` ((4^k, 4^k), complex, on
        the row qubits ``qubits`` then their columns, in that order): the map
        of ``prims`` gates and the channels after each, composed by the
        caller. k <= 2 runs in one pass of the gate kernel, which rounds
        ``s`` to complex64 once. The caller opens the span around the build
        and this call."""
        row, col = self._channel_targets(qubits)
        A.apply_gate(self.state, s, row + col, 2 * self.n)
        profiling.count("rho_fused_passes")
        profiling.count("rho_fused_prims", prims)
        return self

    def apply_channel_plain(self, kraus, targets) -> "DensityMatrix":
        """The same map term by term, as the JAX package writes it: each
        K_i (row) and conj(K_i) (column) applied to a copy of the input, the
        terms added."""
        row, col = self._channel_targets(targets)
        acc = None
        for k in kraus:
            k = np.asarray(k, dtype=np.complex128)
            term = A.apply_gate(self.state.clone(), k, row, 2 * self.n)
            term = A.apply_gate(term, np.conj(k), col, 2 * self.n)
            acc = term if acc is None else acc.add_(term)
        self.state.copy_(acc)
        return self

    # -- readout ------------------------------------------------------------

    def _diagonal(self) -> torch.Tensor:
        d = 1 << self.n
        return torch.diagonal(self.state.view(d, d))

    def probs(self) -> np.ndarray:
        """(2^n,) computational-basis probabilities (the diagonal), float64
        on the host."""
        with profiling.span("qubism.density.readout"):
            return self._diagonal().real.double().cpu().numpy()

    def trace(self) -> float:
        with profiling.span("qubism.density.readout"):
            return float(self._diagonal().real.sum(dtype=torch.float64))

    def purity(self) -> float:
        """Tr(rho^2), 1.0 iff pure (the vectorized norm squared)."""
        rows = self.state.view(-1, min(self.state.numel(), _NORM_CHUNK))
        return float(torch.linalg.vector_norm(rows, dim=1).double().square_().sum())

    def expectation(self, pauli: str) -> float:
        """Tr(P rho): a gather of the 2^n entries rho[x, x ^ f], signed and
        summed in float64."""
        pauli = _measure._check_pauli(pauli, self.n)
        idx, signs, n_y = pauli_trace_entries(pauli, self.n)
        dev = self.state.device
        vals = self.state[torch.from_numpy(idx).to(dev)]
        s = (torch.view_as_real(vals).double()
             * torch.from_numpy(signs).to(dev)[:, None]).sum(dim=0).cpu().numpy()
        return float(_measure._apply_iy(s[0], s[1], n_y).real)

    def expectation_sum(self, terms) -> float:
        return float(sum(c * self.expectation(p) for c, p in terms))

    def sample(self, shots: int, gen: torch.Generator | None = None) -> dict[str, int]:
        """Non-destructive computational-basis shot sampling from the
        diagonal: {big-endian bitstring: count}."""
        with profiling.span("qubism.density.readout"):
            return sample_diagonal(self.probs(), self.n, shots, gen)

    def prob_one(self, q: int) -> float:
        """Born probability that measuring qubit q yields 1."""
        return prob_one_of(self.probs(), self.n, q)

    def _project(self, q: int, outcome: int):
        """Keep the block of rho whose row and column qubit q read
        ``outcome``, and renormalize by the trace (a zero trace leaves the
        zero matrix)."""
        proj = np.array([1.0 - outcome, float(outcome)], dtype=complex)
        A.apply_diag(self.state, proj, (q,), 2 * self.n)
        A.apply_diag(self.state, proj, (q + self.n,), 2 * self.n)
        tr = self.trace()
        self.state.mul_(0.0 if tr == 0 else 1.0 / tr)

    def reset(self, q: int) -> "DensityMatrix":
        """Project qubit q onto |0> and renormalize by the trace: the
        reference's reset semantics (projection WITHOUT a Born draw,
        src/Qubism/QASM/Simulation.hs:146-156)."""
        self._project(q, 0)
        return self

    def measure_qubit(self, q: int, gen: torch.Generator | None = None,
                      uniform: float | None = None) -> int:
        """Sample qubit q (one uniform of ``gen``, or ``uniform``), project
        rho, renormalize by the trace. Returns the outcome."""
        with profiling.span("qubism.density.readout"):
            outcome = born_outcome(self.prob_one(q), gen, uniform)
            self._project(q, outcome)
        return outcome
