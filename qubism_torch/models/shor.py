"""Shor's algorithm: quantum order finding + the classical factoring
wrapper.

Counterpart of qubism_tpu/models/shor.py. The controlled modular
multiplications are dense prims on k + 1 targets (5 at N = 15, 6 at
N = 21), which no kernel takes off the lane block: the JAX package runs
this circuit on its plain XLA path, and the port runs it prim by prim
through ``ops.apply`` (K1, K2 or K3 where a prim fits one, the plain dense
applier where it does not), on a state of t + k <= 16 qubits.

The quantum core is textbook QPE over the modular-multiplication unitary
U_a |x> = |a x mod N> — a PERMUTATION, so every controlled power
U_a^(2^q) is one (k+1)-qubit 0/1 prim built host-side by repeated
squaring (no gate decomposition: the engine applies arbitrary-width
blocks, and a permutation row has one nonzero so the pass stays
memory-bound). Conventions mirror :func:`qubism_torch.models.circuits.qpe_prims`:
counting qubit q kicks back weight 2^q and the swap-free inverse circuit
QFT leaves the register readable big-endian as round(phase * 2^t).

Measured phases s/r are decoded by continued fractions; the classical
wrapper does the even-order / gcd dance. ``shor_factor(15)`` and
``shor_factor(21)`` run end to end in tests.

The reference (a QASM interpreter) could in principle *parse* a Shor
circuit but has no machinery to build one; this is a beyond-reference
model family.
"""

from __future__ import annotations

import math
import random
from fractions import Fraction

import numpy as np

from ..core.gates import Prim

_H = np.array([[1.0, 1.0], [1.0, -1.0]], dtype=complex) / math.sqrt(2.0)
_X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)


def mod_mult_matrix(a: int, n_mod: int, k: int) -> np.ndarray:
    """The (2^k, 2^k) permutation |x> -> |a x mod N| for x < N, identity
    on the unused basis states x >= N (keeps the matrix unitary)."""
    if math.gcd(a, n_mod) != 1:
        raise ValueError(f"a={a} shares a factor with N={n_mod}")
    if (1 << k) < n_mod:
        raise ValueError(f"2^{k} < N={n_mod}")
    dim = 1 << k
    u = np.zeros((dim, dim), dtype=complex)
    for x in range(dim):
        y = (a * x) % n_mod if x < n_mod else x
        u[y, x] = 1.0
    return u


def controlled_mod_mult_prim(a: int, n_mod: int, control: int,
                             work: tuple[int, ...]) -> Prim:
    """block-diag(I, U_a) on (control, *work) — control is the local MSB."""
    k = len(work)
    dim = 1 << k
    u = np.eye(2 * dim, dtype=complex)
    u[dim:, dim:] = mod_mult_matrix(a, n_mod, k)
    return Prim(u, (control,) + tuple(work))


def shor_order_prims(a: int, n_mod: int, t: int) -> tuple[list[Prim], int]:
    """The order-finding circuit: t counting qubits (0..t-1) + k work
    qubits (t..t+k-1, prepared in |1>). Returns (prims, total_qubits);
    measure the counting register big-endian and divide by 2^t for the
    phase."""
    k = (n_mod - 1).bit_length()
    n = t + k
    work = tuple(range(t, t + k))
    prims: list[Prim] = [Prim(_X, (t + k - 1,))]  # |work> = |1>
    for q in range(t):
        prims.append(Prim(_H, (q,)))
    apow = a % n_mod
    for q in range(t):
        prims.append(controlled_mod_mult_prim(apow, n_mod, q, work))
        apow = (apow * apow) % n_mod
    # swap-free inverse circuit QFT (same block as qpe_prims)
    for q in range(t - 1, -1, -1):
        for j in range(t - 1, q, -1):
            lam = -math.pi / (1 << (j - q))
            d = np.array([1.0, 1.0, 1.0, np.exp(1j * lam)], dtype=complex)
            prims.append(Prim(d, (j, q), diag=True))
        prims.append(Prim(_H, (q,)))
    return prims, n


def phase_to_order(phase: float, n_mod: int) -> list[int]:
    """Candidate orders from one measured phase: the denominators of the
    continued-fraction convergents of ``phase`` with denominator < N
    (plus small multiples, for when the sampled s shares a factor
    with r)."""
    if phase <= 0.0:
        return []
    frac = Fraction(phase).limit_denominator(n_mod - 1)
    r = frac.denominator
    out = []
    for m in (1, 2, 3, 4):
        if m * r < n_mod:
            out.append(m * r)
    return out


def estimate_order(a: int, n_mod: int, t: int | None = None,
                   shots: int = 32, seed: int = 0) -> int | None:
    """Run the order-finding circuit and decode the order of a mod N.
    Returns the smallest verified r with a^r = 1 (mod N), or None if no
    sampled phase decodes (raise shots/t)."""
    from ..core.statevec import StateVec
    from ..ops import apply as A
    from .xeb import counts_to_indices

    if t is None:
        t = 2 * (n_mod - 1).bit_length() + 1
    prims, n = shor_order_prims(a, n_mod, t)
    state = A.zero_state(n)
    for p in prims:
        (A.apply_diag if p.diag else A.apply_gate)(state, p.u, p.targets, n)
    sv = StateVec(n, state)
    k = n - t
    idx = counts_to_indices(sv.sample(shots, seed=seed))
    candidates: set[int] = set()
    for v in np.unique(idx >> k):
        candidates.update(phase_to_order(float(v) / (1 << t), n_mod))
    for r in sorted(candidates):
        if pow(a, r, n_mod) == 1:
            return r
    return None


def shor_factor(n_mod: int, seed: int = 0, attempts: int = 20,
                t: int | None = None, shots: int = 32) -> tuple[int, int]:
    """Factor N = p*q via quantum order finding. Handles the classical
    shortcuts (even N, perfect powers, lucky gcd) the standard way."""
    if n_mod < 4:
        raise ValueError("N must be a composite >= 4")
    if n_mod % 2 == 0:
        return 2, n_mod // 2
    for b in range(2, n_mod.bit_length() + 1):
        root = round(n_mod ** (1.0 / b))
        for cand in (root - 1, root, root + 1):
            if cand > 1 and cand ** b == n_mod:
                return cand, n_mod // cand
    rng = random.Random(seed)
    for trial in range(attempts):
        a = rng.randrange(2, n_mod - 1)
        g = math.gcd(a, n_mod)
        if g > 1:
            return g, n_mod // g
        r = estimate_order(a, n_mod, t=t, shots=shots,
                           seed=seed * 1000 + trial)
        if r is None or r % 2:
            continue
        y = pow(a, r // 2, n_mod)
        if y == n_mod - 1:
            continue
        for g in (math.gcd(y - 1, n_mod), math.gcd(y + 1, n_mod)):
            if 1 < g < n_mod:
                return g, n_mod // g
    raise RuntimeError(
        f"no factor found for N={n_mod} in {attempts} attempts "
        f"(raise attempts/shots/t)")
