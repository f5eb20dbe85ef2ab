"""State and process tomography on the simulator's engines.

Counterpart of qubism_tpu/models/tomography.py: the exact readouts from
the port's ``DensityMatrix`` and ``CompiledCircuit``, the sampled ones from
its inverse-CDF sampler (``ops.sample.sample_indices``) driven by a seeded
``torch.Generator`` (so a seed's shots differ from the JAX package's, not
their distribution).

State tomography: rho = 2^-n sum_P <P> P over all 4^n Pauli strings.
Expectations come exact (DensityMatrix / statevector) or SAMPLED the way
hardware measures them — per Pauli string the circuit is rotated into the
Z basis (H for X, H S^dag for Y) and computational-basis shots are drawn
from the engine sampler; the linear-inversion estimate is then projected
to the physical (PSD, trace-1) cone with the Smolin-Gambetta-Smith
algorithm (closed-form max-likelihood projection, PRL 108 070502).

Process tomography: a k-qubit channel is reconstructed as its Choi matrix
from the informationally complete product inputs {|0>, |1>, |+>, |+i>}^k:
matrix units decompose as |0><1| = |+><+| + i|+i><+i| - (1+i)/2 (|0><0| +
|1><1|), so E(|i><j|) — and hence Choi = sum_ij |i><j| x E(|i><j|) — is a
linear combination of the channel's action on 4^k physical states, each
one DensityMatrix run.  Process fidelity against an ideal unitary follows
as F = <phi_U| Choi |phi_U> / d^2.

Demo scale (n <= 5 state / k <= 2 process: 4^n expectations are the
protocol's own exponential cost, not an engine limit).  Engine extension:
the reference has no mixed states and no tomography
(src/Qubism/StateVec.hs)."""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np

from ..core.density import DensityMatrix
from ..core.gates import Prim
from ..ops.fusion import CompiledCircuit
from ..ops import sample as _sample

_I2 = np.eye(2, dtype=np.complex128)
_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
_Z = np.diag([1.0, -1.0]).astype(np.complex128)
_H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / math.sqrt(2)
_SDG = np.diag([1.0, -1j]).astype(np.complex128)
_PAULI = {"I": _I2, "X": _X, "Y": _Y, "Z": _Z}
# U P U^dag = Z for the non-identity axes (verified in tests)
_BASIS_ROT = {"X": _H, "Y": _H @ _SDG}


def pauli_strings(n: int) -> list[str]:
    return ["".join(t) for t in itertools.product("IXYZ", repeat=n)]


@functools.lru_cache(maxsize=None)
def pauli_matrix(s: str) -> np.ndarray:
    m = np.array([[1.0]], dtype=np.complex128)
    for c in s:
        m = np.kron(m, _PAULI[c])
    return m


def reconstruct_state(expectations: dict[str, float], n: int) -> np.ndarray:
    """Linear inversion: rho = 2^-n sum <P> P (unphysical under sampling
    noise — follow with project_to_physical)."""
    d = 1 << n
    rho = np.zeros((d, d), dtype=np.complex128)
    for p, v in expectations.items():
        rho += v * pauli_matrix(p)
    return rho / d


def project_to_physical(rho: np.ndarray) -> np.ndarray:
    """Smolin-Gambetta-Smith: closed-form projection to the nearest (2-norm)
    density matrix — eigenvalues clipped largest-first so the removed
    negative mass is spread over the surviving ones."""
    rho = 0.5 * (rho + rho.conj().T)
    rho = rho / np.trace(rho).real
    w, v = np.linalg.eigh(rho)
    w = w[::-1].copy()          # descending
    v = v[:, ::-1]
    d = len(w)
    acc = 0.0
    for i in range(d - 1, -1, -1):
        if w[i] + acc / (i + 1) < 0:
            acc += w[i]
            w[i] = 0.0
        else:
            w[:i + 1] += acc / (i + 1)
            break
    return (v * w) @ v.conj().T


def fidelity(rho: np.ndarray, sigma: np.ndarray) -> float:
    """Uhlmann fidelity F(rho, sigma) = (tr sqrt(sqrt(rho) sigma sqrt(rho)))^2."""
    w, v = np.linalg.eigh(rho)
    sq = (v * np.sqrt(np.clip(w, 0, None))) @ v.conj().T
    m = sq @ sigma @ sq
    ev = np.linalg.eigvalsh(m)
    return float(np.sum(np.sqrt(np.clip(ev, 0, None))) ** 2)


def exact_state_tomography(rho: DensityMatrix) -> dict[str, float]:
    """All 4^n exact expectations from the density engine (n <= 5)."""
    if rho.n > 5:
        raise ValueError("exact_state_tomography: n <= 5 (4^n readouts)")
    return {p: rho.expectation(p) for p in pauli_strings(rho.n)}


def _basis_rotation_prims(pauli: str) -> list[Prim]:
    return [Prim(_BASIS_ROT[c], (q,))
            for q, c in enumerate(pauli) if c in _BASIS_ROT]


def _parity_signs(pauli: str, n: int) -> np.ndarray:
    """(-1)^(popcount over the string's support) per basis index."""
    idx = np.arange(1 << n)
    signs = np.ones(1 << n, dtype=np.float64)
    for q, c in enumerate(pauli):
        if c != "I":
            bit = (idx >> (n - 1 - q)) & 1
            signs *= 1.0 - 2.0 * bit
    return signs


def sampled_state_tomography(prims, n: int, shots: int = 2048,
                             seed: int = 0) -> dict[str, float]:
    """Hardware-style tomography of the pure state prepared by ``prims``:
    per Pauli string, rotate into the Z basis and draw engine shots (one
    CPU generator seeded with ``seed`` for every string, in order)."""
    import torch

    if n > 5:
        raise ValueError("sampled_state_tomography: n <= 5")
    out: dict[str, float] = {}
    gen = torch.Generator().manual_seed(int(seed))
    for p in pauli_strings(n):
        if set(p) == {"I"}:
            out[p] = 1.0
            continue
        c = CompiledCircuit(n, list(prims) + _basis_rotation_prims(p))
        state = c(c.init_state())
        idx = _sample.sample_indices(state, n, shots, gen)
        signs = _parity_signs(p, n)
        out[p] = float(signs[idx].mean())
    return out


# -- direct fidelity estimation (Flammia-Liu PRL 106 230501) ---------------------


def characteristic_fn(prims, n: int) -> dict[str, float]:
    """chi(P) = <psi|P|psi> for every Pauli string, for the pure state
    prepared by ``prims`` (n <= 5; sum of chi^2 / 2^n = 1 for pure states)."""
    if n > 5:
        raise ValueError("characteristic_fn: n <= 5 (4^n expectations)")
    c = CompiledCircuit(n, list(prims))
    amps = c.state_to_complex(c(c.init_state()))
    return {p: float(np.real(amps.conj() @ (pauli_matrix(p) @ amps)))
            for p in pauli_strings(n)}


def direct_fidelity_estimate(prims, n: int, noisy_expectation_fn,
                             n_paulis: int = 64, seed: int = 0,
                             chi_cut: float = 1e-9):
    """Flammia-Liu DFE of F = <psi|rho|psi> against the pure target
    prepared by ``prims``: sample Pauli strings P with probability
    chi_psi(P)^2 / 2^n, measure <P> on the device
    (``noisy_expectation_fn(pauli) -> float``), and average the ratio
    chi_rho(P)/chi_psi(P).  Needs O(1/eps^2) Paulis independent of n —
    never full tomography.  Returns (estimate, stderr)."""
    chi = characteristic_fn(prims, n)
    labels = [p for p, v in chi.items() if abs(v) > chi_cut]
    weights = np.array([chi[p] ** 2 for p in labels], dtype=np.float64)
    weights /= weights.sum()
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(labels), size=n_paulis, p=weights)
    vals = np.array([noisy_expectation_fn(labels[i]) / chi[labels[i]]
                     for i in picks], dtype=np.float64)
    est = float(vals.mean())
    se = float(vals.std(ddof=1) / math.sqrt(n_paulis)) if n_paulis > 1 else \
        float("inf")
    return est, se


# -- process tomography ----------------------------------------------------------

# 1q IC input states |s><s| and the complex weights expressing the matrix
# units E_ij = |i><j| in terms of them:
#   E_00 = P0, E_11 = P1,
#   E_01 = P+ + i P_i - (1+i)/2 (P0 + P1),  E_10 = E_01^dag (conjugate weights)
_KETS = {
    "0": np.array([1, 0], dtype=np.complex128),
    "1": np.array([0, 1], dtype=np.complex128),
    "+": np.array([1, 1], dtype=np.complex128) / math.sqrt(2),
    "i": np.array([1, 1j], dtype=np.complex128) / math.sqrt(2),
}
_UNIT_WEIGHTS = {
    (0, 0): {"0": 1.0},
    (1, 1): {"1": 1.0},
    (0, 1): {"+": 1.0, "i": 1.0j, "0": -(1 + 1j) / 2, "1": -(1 + 1j) / 2},
    (1, 0): {"+": 1.0, "i": -1.0j, "0": -(1 - 1j) / 2, "1": -(1 - 1j) / 2},
}


def _prep_prim(labels: str, k: int) -> Prim:
    """One dense k-qubit prim preparing the product state from |0..0>:
    any unitary whose first column is the target ket."""
    ket = np.array([1.0], dtype=np.complex128)
    for c in labels:
        ket = np.kron(ket, _KETS[c])
    d = 1 << k
    m = np.zeros((d, d), dtype=np.complex128)
    m[:, 0] = ket
    # complete to a unitary (Gram-Schmidt against the remaining basis)
    cols = [ket]
    for j in range(d):
        e = np.zeros(d, dtype=np.complex128)
        e[j] = 1.0
        for cvec in cols:
            e = e - cvec * (cvec.conj() @ e)
        nrm = np.linalg.norm(e)
        if nrm > 1e-9:
            e = e / nrm
            cols.append(e)
            m[:, len(cols) - 1] = e
        if len(cols) == d:
            break
    return Prim(m, tuple(range(k)))


def process_tomography(apply_channel_fn, k: int) -> np.ndarray:
    """Choi matrix (column-stacking convention, trace d) of a k-qubit
    channel from its action on the 4^k IC product inputs.

    ``apply_channel_fn(rho: DensityMatrix) -> DensityMatrix`` is the
    channel under test (e.g. ``lambda r: r.apply_channel(kraus, (0,))`` or
    a whole noisy circuit)."""
    if k > 2:
        raise ValueError("process_tomography: k <= 2 (4^k engine runs)")
    d = 1 << k
    outputs: dict[str, np.ndarray] = {}
    for labels in itertools.product("01+i", repeat=k):
        s = "".join(labels)
        rho_in = DensityMatrix(k).apply([_prep_prim(s, k)])
        outputs[s] = apply_channel_fn(rho_in).matrix()
    choi = np.zeros((d * d, d * d), dtype=np.complex128)
    for ij in itertools.product(range(2), repeat=2 * k):
        i_bits, j_bits = ij[:k], ij[k:]
        i = int("".join(map(str, i_bits)), 2)
        j = int("".join(map(str, j_bits)), 2)
        # E(|i><j|) as the tensor-product combination of 1q unit weights
        e_out = np.zeros((d, d), dtype=np.complex128)
        combos = [(1.0, "")]
        for q in range(k):
            w = _UNIT_WEIGHTS[(i_bits[q], j_bits[q])]
            combos = [(c * cw, s + lab) for c, s in combos
                      for lab, cw in w.items()]
        for coef, labels in combos:
            e_out += coef * outputs[labels]
        unit = np.zeros((d, d), dtype=np.complex128)
        unit[i, j] = 1.0
        choi += np.kron(unit, e_out)
    return choi


def choi_from_kraus(kraus) -> np.ndarray:
    """Analytic Choi (same convention) for a Kraus channel."""
    d = kraus[0].shape[0]
    omega = np.zeros((d * d, 1), dtype=np.complex128)
    for i in range(d):
        omega[i * d + i] = 1.0
    choi = np.zeros((d * d, d * d), dtype=np.complex128)
    for kmat in kraus:
        v = np.kron(np.eye(d), np.asarray(kmat, dtype=np.complex128)) @ omega
        choi += v @ v.conj().T
    return choi


def process_fidelity(choi: np.ndarray, u: np.ndarray) -> float:
    """F_pro = <phi_U| Choi |phi_U> / d^2 against the ideal unitary u."""
    d = u.shape[0]
    phi = np.zeros(d * d, dtype=np.complex128)
    for i in range(d):
        phi[i * d: i * d + d] += np.asarray(u, dtype=np.complex128)[:, i]
    return float(np.real(phi.conj() @ choi @ phi) / d ** 2)
