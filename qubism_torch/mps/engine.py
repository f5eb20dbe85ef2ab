"""Matrix-product-state circuit engine on PyTorch.

Counterpart of qubism_tpu/mps/engine.py: a third simulation regime beside
the dense state vector (O(2^n)) and the Clifford tableau (O(n^2) bits),
for bounded-entanglement circuits at 100+ qubits in O(n chi^2) memory.

* **One tensor.** The n site tensors live in ONE ``(n, chi, 2, chi)``
  complex64 tensor on ``config.device`` (a trajectory batch adds a leading
  ``T``): qubit q at site q, qubit 0 the most significant bit, bonds padded
  to a fixed ``chi``.
* **Gate application is contract -> SVD -> truncate** at the
  orthogonality center, which the host tracks as an integer. A whole prim
  stream is flattened on the host into an opcode tape (:func:`build_tape`:
  SWAP routing and center shifts included), its 4x4 operands go to the
  device in one upload, and :func:`run_tape` walks the rows, dispatching on
  the opcode in Python. The SVD is ``torch.linalg.svd`` (batched over the
  trajectories), with numpy's ``matrix_rank`` rule deciding which singular
  values are zero (a value at or below ``max(m, n) * eps32 * s_max``); the
  truncated weight is the sum of the squares of the DROPPED singular
  values, so an exact run reports exactly 0.0.
* **Sampling and expectations are exact transfer contractions**, walked
  site by site with the shots (or the stacked Pauli strings) as a batch
  dimension: O(n) launches whatever their number. Correctness never depends
  on canonical-form invariants, so padding is harmless.
* **Non-adjacent gates ride SWAP routing**: the far qubit walks next to its
  partner, the gate applies, the qubit walks back.

The discarded weight stays a device scalar until ``trunc_error`` is read;
under a ``trunc_budget`` it is read once per ``apply``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.gates import Gate, Prim
from ..ops import apply as A
from ..ops.apply import _sort_targets

__all__ = ["MPSSim", "NotAdjacentError", "build_tape", "pack_tape", "run_tape"]

_SWAP = np.eye(4, dtype=complex)[[0, 2, 1, 3]]
#: float32 machine epsilon: the rank rule's unit
_EPS32 = float(np.finfo(np.float32).eps)


class NotAdjacentError(ValueError):
    """Raised for k>2-qubit prims the MPS backend cannot route."""


#: Tape opcodes: the host flattens a prim stream (SWAP routing and center
#: shifts included) into (opcode, site, u) rows; run_tape replays them.
_OP_2Q, _OP_SHIFT_R, _OP_SHIFT_L, _OP_1Q, _OP_NOP = range(5)
#: General 1-qubit 2-Kraus channel row (state-DEPENDENT branch choice:
#: amplitude/phase damping): K0 in u[:2, :2], K1 in u[:2, 2:4]; the branch
#: uniform comes with the row.
_OP_K1Q = 5

_PAULI = {
    "I": np.eye(2, dtype=complex),
    "X": np.array([[0, 1], [1, 0]], dtype=complex),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=complex),
    "Z": np.diag([1.0, -1.0]).astype(complex),
}


# ---------------------------------------------------------------------------
# Row bodies: ``sites`` is (..., n, chi, 2, chi) and is written in place;
# an operand is (2, 2) / (4, 4), or one per batch row, (B, 2, 2) / (B, 4, 4)
# ---------------------------------------------------------------------------


def _lead(sites):
    return sites.shape[:-4]


def _op(u):
    """An operand broadcast against a site's (..., chi, 2|4, chi) blocks."""
    return u if u.dim() == 2 else u.unsqueeze(-3)


def _apply_1q_(sites, u, q: int) -> None:
    a = sites[..., q, :, :, :]
    a.copy_(torch.matmul(_op(u), a))


def _svd(m):
    """Thin SVD of a (batch of) complex64 matrix, with its singular values
    below numpy's matrix_rank rule (at or below max(rows, cols) * eps32 *
    s_max) set to exactly zero: they are round-off, and left in they carry
    ever smaller entries (down to 1e-35) into later SVDs, where LAPACK's
    single-precision divide and conquer then fails to converge. Should it
    fail all the same, the matrix is decomposed again in complex128."""
    try:
        uu, s, vh = torch.linalg.svd(m, full_matrices=False)
    except torch.linalg.LinAlgError:
        uu, s, vh = torch.linalg.svd(m.to(torch.complex128), full_matrices=False)
        uu, s, vh = uu.to(m.dtype), s.to(torch.float32), vh.to(m.dtype)
    s = torch.where(s > s[..., :1] * (max(m.shape[-2:]) * _EPS32), s, 0.0)
    return uu, s, vh


def _apply_2q_(sites, u, q: int) -> torch.Tensor:
    """Dense 4x4 on adjacent sites (q, q+1), truncating SVD back to chi.
    Renormalises the kept spectrum so the norm is preserved; returns the
    discarded weight (the sum of the squares of the dropped singular
    values, (...) float32)."""
    lead, chi = _lead(sites), sites.shape[-1]
    a, b = sites[..., q, :, :, :], sites[..., q + 1, :, :, :]
    th = torch.matmul(a.view(lead + (2 * chi, chi)), b.view(lead + (chi, 2 * chi)))
    th = torch.matmul(_op(u), th.view(lead + (chi, 4, chi)))
    uu, s, vh = _svd(th.view(lead + (2 * chi, 2 * chi)))
    s2 = s * s
    kept = s2[..., :chi].sum(-1)
    disc = s2[..., chi:].sum(-1)
    scale = torch.sqrt((kept + disc) / kept.clamp_min(1e-30))
    a.view(lead + (2 * chi, chi)).copy_(uu[..., :chi])
    b.view(lead + (chi, 2 * chi)).copy_((s[..., :chi] * scale[..., None])[..., None]
                                        * vh[..., :chi, :])
    return disc


def _shift_right_(sites, c: int) -> None:
    """Site c becomes an isometry by SVD (A = U diag(s) V^H); diag(s) V^H
    is absorbed into site c+1 (center c -> c+1)."""
    lead, chi = _lead(sites), sites.shape[-1]
    a, b = sites[..., c, :, :, :], sites[..., c + 1, :, :, :]
    uu, s, vh = _svd(a.view(lead + (2 * chi, chi)))
    a.view(lead + (2 * chi, chi)).copy_(uu)
    b2 = b.view(lead + (chi, 2 * chi))
    b2.copy_(torch.matmul(s[..., None] * vh, b2))


def _shift_left_(sites, c: int) -> None:
    """Mirror of _shift_right_: the SVD of site c as (chi, 2chi) leaves the
    row isometry V^H there and absorbs U diag(s) into site c-1."""
    lead, chi = _lead(sites), sites.shape[-1]
    a, b = sites[..., c, :, :, :], sites[..., c - 1, :, :, :]
    uu, s, vh = _svd(a.view(lead + (chi, 2 * chi)))
    a.view(lead + (chi, 2 * chi)).copy_(vh)
    b2 = b.view(lead + (2 * chi, chi))
    b2.copy_(torch.matmul(b2, uu * s[..., None, :]))


def _apply_k1q_(sites, u, kk, uni, q: int) -> None:
    """MCWF branch of a 2-Kraus channel: p(K0) = ||K0 psi||^2 / ||psi||^2
    by one exact transfer contraction (``kk`` = stack(I, K0^H K0)); the
    chosen branch is renormalised back to the incoming norm."""
    vals = walk_expect(sites, 2, {q: kk}).real
    ntot = vals[..., 0].clamp_min(1e-30)
    n0 = vals[..., 1]
    take0 = uni < n0 / ntot
    a = sites[..., q, :, :, :]
    r0 = torch.matmul(u[:2, :2], a)
    r1 = torch.matmul(u[:2, 2:4], a)
    sc = _renorm(torch.where(take0, n0, ntot - n0) / ntot)
    bc = (...,) + (None,) * 3
    a.copy_(torch.where(take0[bc], r0, r1) * sc[bc])


def _renorm(w):
    """The factor that renormalises a branch of weight ``w``: w^-1/2, and 1
    for a branch of no weight (a reset of a |1>-certain qubit): its state
    stays the zero vector it is, where w^-1/2 of round-off would grow
    entries past float32's range in later contractions."""
    return torch.where(w > 1e-30, torch.rsqrt(w.clamp_min(1e-30)), 1.0)


def run_tape(sites, codes, qs, us, over=None, kuni=None, kks=None) -> torch.Tensor:
    """Replay a tape in place on ``sites``. ``codes``/``qs`` are host
    sequences, ``us`` the (L, 4, 4) complex64 operands on the device (1q
    gates in the top-left 2x2 block); ``over`` maps a 1q row to a per-batch
    (B, 2, 2) operand (sampled noise), ``kuni`` a K1Q row to its (B,)
    uniforms and ``kks`` to its stack(I, K0^H K0) on the device. Returns
    the discarded weight, (...) float32 on the device."""
    over = over or {}
    parts = []
    for k, (code, q) in enumerate(zip(codes, qs)):
        if code == _OP_1Q:
            u = over.get(k)
            _apply_1q_(sites, us[k, :2, :2] if u is None else u, q)
        elif code == _OP_2Q:
            parts.append(_apply_2q_(sites, us[k], q))
        elif code == _OP_SHIFT_R:
            _shift_right_(sites, q)
        elif code == _OP_SHIFT_L:
            _shift_left_(sites, q)
        elif code == _OP_K1Q:
            _apply_k1q_(sites, us[k], kks[k], kuni[k], q)
    if not parts:
        return torch.zeros(_lead(sites), dtype=torch.float32, device=sites.device)
    return torch.stack(parts).sum(0)


# ---------------------------------------------------------------------------
# Transfer contractions
# ---------------------------------------------------------------------------


def _e0(shape, chi, dev):
    e = torch.zeros(shape + (chi, chi), dtype=torch.complex64, device=dev)
    e[..., 0, 0] = 1
    return e


def walk_expect(sites, k: int, site_ops) -> torch.Tensor:
    """<psi| prod_i O_i |psi> for k operator strings at once: ``site_ops``
    maps a site to its (k, 2, 2) operators (or (..., k, 2, 2), one per
    batch row), every other site is the identity in all k. One walk over
    the sites with e0 boundaries; returns (..., k) complex64."""
    lead, n, chi = _lead(sites), sites.shape[-4], sites.shape[-1]
    e = _e0(lead + (k,), chi, sites.device)            # E[bra, ket]
    for i in range(n):
        a = sites[..., i, :, :, :]
        t = torch.matmul(e, a.view(lead + (1, chi, 2 * chi)))
        t = t.view(lead + (k, chi, 2, chi))
        o = site_ops.get(i)
        if o is not None:
            t = torch.matmul(o.unsqueeze(-3), t)
        e = torch.matmul(a.view(lead + (1, 2 * chi, chi)).mH, t.view(lead + (k, 2 * chi, chi)))
    return e[..., 0, 0]


def norm2(sites) -> torch.Tensor:
    """<psi|psi>, (...) float32."""
    return walk_expect(sites, 1, {})[..., 0].real


def right_envs(sites) -> torch.Tensor:
    """env[i]: the contraction of sites i+1..n-1 with the e0 boundary
    (env[b, b'], ket index first), so p(prefix) = v env v^H. (n, ...,
    chi, chi)."""
    lead, n, chi = _lead(sites), sites.shape[-4], sites.shape[-1]
    e = _e0(lead, chi, sites.device)
    envs = [e]
    for i in range(n - 1, 0, -1):
        a = sites[..., i, :, :, :]
        t = torch.matmul(a.view(lead + (2 * chi, chi)), e).view(lead + (chi, 2 * chi))
        e = torch.matmul(t, a.view(lead + (chi, 2 * chi)).mH)
        envs.append(e)
    return torch.stack(envs[::-1])


def sample_bits(sites, u) -> torch.Tensor:
    """Perfect MPS sampling: ``u`` is the (shots, n) float32 uniform table
    on the device; each site conditions every shot on the exact
    right-environment stack (valid for any, even non-canonical, MPS):
    ``bit = u * (p0 + p1) >= p0``, then renormalise. (shots, n) uint8."""
    n, chi = sites.shape[-4], sites.shape[-1]
    envs = right_envs(sites)
    v = torch.zeros((u.shape[0], chi), dtype=torch.complex64, device=sites.device)
    v[:, 0] = 1
    bits = []
    for i in range(n):
        w = torch.matmul(v, sites[i].view(chi, 2 * chi)).view(-1, 2, chi)
        p = (torch.matmul(w, envs[i]) * w.conj()).real.sum(-1)     # (shots, 2)
        bit = u[:, i] * p.sum(-1) >= p[:, 0]
        v = torch.where(bit[:, None], w[:, 1], w[:, 0])
        v = v * torch.rsqrt(torch.where(bit, p[:, 1], p[:, 0]).clamp_min(1e-30))[:, None]
        bits.append(bit)
    return torch.stack(bits, 1).to(torch.uint8)


# ---------------------------------------------------------------------------
# Host-side tape construction
# ---------------------------------------------------------------------------


def build_tape(prims, center: int, on_gate=None):
    """Flatten a prim iterable into (code, site, u) tape rows, SWAP routing
    and orthogonality-center shifts included. ``on_gate(tape, sites,
    logical)``, if given, runs right after each CIRCUIT gate's rows land
    (before any SWAP walk-back), with the physical site(s) the gate's
    logical qubits occupy at that moment and the matching LOGICAL qubit
    indices (they differ only for routed non-adjacent 2q gates): the noise
    slot hook of mps/noise.py. Returns (tape, final_center)."""
    tape = []

    def move(target):
        nonlocal center
        while center < target:
            tape.append((_OP_SHIFT_R, center, None))
            center += 1
        while center > target:
            tape.append((_OP_SHIFT_L, center, None))
            center -= 1

    def adj2(u, q):
        nonlocal center
        move(q if center <= q else q + 1)
        tape.append((_OP_2Q, q, u))
        center = q + 1

    for p in prims:
        u = np.diag(p.u) if p.diag else np.asarray(p.u)
        un, tgts = _sort_targets(np.asarray(u, dtype=np.complex128), p.targets)
        if len(tgts) == 1:
            tape.append((_OP_1Q, tgts[0], un))
            if on_gate is not None:
                on_gate(tape, (tgts[0],), (tgts[0],))
        elif len(tgts) == 2:
            a, b = tgts
            for j in range(b - 1, a, -1):  # route qubit b down to a+1
                adj2(_SWAP, j)
            adj2(un, a)
            if on_gate is not None:
                on_gate(tape, (a, a + 1), (a, b))
            for j in range(a + 1, b):      # walk it back
                adj2(_SWAP, j)
        else:
            raise NotAdjacentError(
                f"the MPS backend applies 1- and 2-qubit prims; got a "
                f"{len(tgts)}-qubit prim on {tgts}. Decompose it "
                f"(qelib1-style) first.")
    return tape, center


def pack_tape(tape, length: int | None = None):
    """Pack (code, site, u) rows into host arrays: (codes (L,) int32, qs
    (L,) int32, us (L, 4, 4) complex64), padded with NOP rows to
    ``length``."""
    length = len(tape) if length is None else length
    codes = np.full(length, _OP_NOP, dtype=np.int32)
    qs = np.zeros(length, dtype=np.int32)
    us = np.zeros((length, 4, 4), dtype=np.complex64)
    for k, (code, q, u) in enumerate(tape):
        codes[k] = code
        qs[k] = q
        if u is not None:
            d = u.shape[0]
            us[k, :d, :d] = u
    return codes, qs, us


def kraus_norm_ops(us, codes):
    """stack(I, K0^H K0) of each K1Q row of a packed tape, as host (2, 2, 2)
    complex64 arrays by row."""
    out = {}
    for k in np.flatnonzero(np.asarray(codes) == _OP_K1Q):
        k0 = us[k, :2, :2].astype(np.complex128)
        out[int(k)] = np.stack([np.eye(2), k0.conj().T @ k0]).astype(np.complex64)
    return out


def _pauli_ops(strings, n: int, dev, with_norm: bool = True):
    """The site operators of Pauli strings for :func:`walk_expect`, with
    the identity string first when ``with_norm``: one upload."""
    strings = (["I" * n] if with_norm else []) + list(strings)
    ops = np.stack([np.stack([_PAULI[c] for c in s]) for s in strings]).astype(np.complex64)
    dev_ops = torch.from_numpy(ops).to(dev)
    return len(strings), {i: dev_ops[:, i] for i in range(n)
                          if any(s[i] != "I" for s in strings)}


def _check_pauli(pauli: str, n: int):
    if len(pauli) != n or any(c not in _PAULI for c in pauli):
        raise ValueError(f"bad Pauli string for n={n}: {pauli!r}")


# ---------------------------------------------------------------------------
# Host-side simulator
# ---------------------------------------------------------------------------


class MPSSim:
    """Bounded-bond-dimension circuit simulator.

    ``chi`` caps the Schmidt rank across every cut: simulation is exact
    while the circuit's entanglement fits (``trunc_error`` stays 0.0) and
    degrades gracefully past it. Qubit q lives at site q; qubit 0 is the
    most significant basis bit.

    ``trunc_budget`` turns the truncation weight from a report into a
    CONTRACT: when an ``apply`` would push the accumulated ``trunc_error``
    past the budget, the engine rolls the call back (every call works on a
    clone, so the state before it is still held), doubles ``chi``
    (zero-padding the site tensors; exact) and re-runs, up to ``max_chi``.
    A run that hits ``max_chi`` and still exceeds the budget raises
    ``FloatingPointError``.

    Random draws (measurement, sampling) come from a CPU generator seeded
    with ``seed`` (or ``gen``).
    """

    def __init__(self, n: int, chi: int = 32, seed: int | None = None,
                 gen: torch.Generator | None = None, trunc_budget: float | None = None,
                 max_chi: int = 256):
        if n < 1:
            raise ValueError("MPSSim needs n >= 1")
        self.n = n
        self.chi = chi
        self.trunc_budget = trunc_budget
        self.max_chi = max(max_chi, chi)
        self.sites = torch.zeros((n, chi, 2, chi), dtype=torch.complex64, device=A.device())
        self.sites[:, 0, 0, 0] = 1
        self.center = 0
        #: discarded-weight parts stay DEVICE scalars until read
        self._disc_parts: list = []
        self._trunc_host = 0.0
        self.gen = gen if gen is not None else torch.Generator().manual_seed(
            0 if seed is None else seed)

    @property
    def trunc_error(self) -> float:
        """Total discarded Schmidt weight so far (0.0 = exact). Reading it
        syncs the pending device parts, once."""
        if self._disc_parts:
            self._trunc_host += float(torch.stack(self._disc_parts).double().sum())
            self._disc_parts = []
        return self._trunc_host

    def _grow(self, new_chi: int) -> None:
        """Zero-pad every site tensor to ``new_chi`` (exact)."""
        chi = self.chi
        new = torch.zeros((self.n, new_chi, 2, new_chi), dtype=torch.complex64,
                          device=self.sites.device)
        new[:, :chi, :, :chi] = self.sites
        self.sites = new
        self.chi = new_chi

    def _run(self, tape):
        """Replay host tape rows on a clone of the state (one upload of
        their operands); returns (the new sites, the discarded weight)."""
        codes, qs, us = pack_tape(tape)
        work = self.sites.clone()
        disc = run_tape(work, codes.tolist(), qs.tolist(),
                        torch.from_numpy(us).to(work.device))
        return work, disc

    # -- center management ----------------------------------------------------

    def _move_center(self, target: int) -> None:
        tape = []
        while self.center < target:
            tape.append((_OP_SHIFT_R, self.center, None))
            self.center += 1
        while self.center > target:
            tape.append((_OP_SHIFT_L, self.center, None))
            self.center -= 1
        if tape:
            self.sites, _ = self._run(tape)

    # -- gate application -----------------------------------------------------

    def _apply_1q(self, u: np.ndarray, q: int) -> None:
        self.sites, _ = self._run([(_OP_1Q, q, np.asarray(u, dtype=np.complex128))])

    def _scale_site(self, q: int, s: float) -> None:
        new = self.sites.clone()
        new[q] *= s
        self.sites = new

    @staticmethod
    def _flatten(gate_or_prims):
        prims = getattr(gate_or_prims, "prims", gate_or_prims)
        if isinstance(prims, (Gate, Prim)):
            prims = (prims,)
        for p in prims:
            if isinstance(p, Gate):
                yield from MPSSim._flatten(p.prims)
            else:
                yield p

    def apply(self, gate_or_prims) -> "MPSSim":
        """Apply a prim stream: the whole stream, SWAP routing and center
        shifts included, is flattened on the host into one tape whose
        operands go to the device in one upload; the rows replay on a clone
        of the state.

        Under a ``trunc_budget``, a call whose truncation weight would break
        the budget rolls back, doubles ``chi`` and retries (see the class
        docstring); its discarded weight is read once per try."""
        tape, center = build_tape(self._flatten(gate_or_prims), self.center)
        if not tape:
            return self
        while True:
            work, disc = self._run(tape)
            if self.trunc_budget is None:
                self.sites = work
                self._disc_parts.append(disc)
                self.center = center
                return self
            d = float(disc)
            if self.trunc_error + d <= self.trunc_budget:
                self.sites = work
                break
            if self.chi >= self.max_chi:
                raise FloatingPointError(
                    f"trunc_budget {self.trunc_budget:g} exceeded at "
                    f"max_chi={self.max_chi} (this apply discarded "
                    f"{d:g} of Schmidt weight); raise max_chi or the "
                    f"budget")
            self._grow(min(2 * self.chi, self.max_chi))
        self.center = center
        self._trunc_host += d
        return self

    # -- observables ------------------------------------------------------------

    def norm(self) -> float:
        return math.sqrt(max(float(norm2(self.sites)), 0.0))

    def expectation(self, pauli: str) -> float:
        """<psi|P|psi> / <psi|psi> for a length-n I/X/Y/Z string."""
        _check_pauli(pauli, self.n)
        return self.expectation_sum([(1.0, pauli)])

    def expectation_sum(self, terms) -> float:
        """<H> for H = sum coef * P: every string and the norm ride ONE walk
        over the sites (operators stacked (k+1, n, 2, 2))."""
        terms = list(terms)
        for _, pauli in terms:
            _check_pauli(pauli, self.n)
        k, ops = _pauli_ops([p for _, p in terms], self.n, self.sites.device)
        vals = walk_expect(self.sites, k, ops).real.double().cpu().numpy()
        coefs = np.asarray([float(c) for c, _ in terms])
        return float(vals[1:] @ coefs) / max(float(vals[0]), 1e-30)

    def amplitude(self, bits) -> complex:
        """<bits|psi>; bits is an n-sequence of 0/1 (bits[0] = qubit 0)."""
        bits = np.asarray(list(bits), dtype=np.int64)
        if bits.shape != (self.n,):
            raise ValueError("amplitude wants one bit per qubit")
        v = self.sites[0, 0, int(bits[0]), :]
        for i in range(1, self.n):
            v = torch.matmul(v, self.sites[i, :, int(bits[i]), :])
        return complex(v[0].item())

    def to_statevec(self) -> np.ndarray:
        """Dense (2^n,) amplitudes in float64 (test oracle; n <= 14)."""
        if self.n > 14:
            raise ValueError("to_statevec is O(2^n); n > 14 refused")
        a = self.sites.cpu().numpy().astype(np.complex128)
        v = a[0, 0]                       # (2, chi)
        for i in range(1, self.n):
            v = np.einsum("...a,asb->...sb", v, a[i])
        return v[..., 0].reshape(-1)

    # -- measurement / sampling -------------------------------------------------

    def sample(self, shots: int, uniforms=None) -> np.ndarray:
        """``shots`` independent full-register measurements
        (non-destructive). (shots, n) uint8, column q = qubit q. The (shots,
        n) uniform table is drawn from the generator, or given as
        ``uniforms``; shot s takes qubit q's bit by ``u[s, q] * (p0 + p1) >=
        p0`` of its conditional (unnormalised) probabilities."""
        if uniforms is None:
            uniforms = torch.rand((shots, self.n), generator=self.gen, dtype=torch.float64)
        u = torch.as_tensor(np.asarray(uniforms, dtype=np.float32).reshape(shots, self.n))
        return sample_bits(self.sites, u.to(self.sites.device)).cpu().numpy()

    def prob_one(self, q: int) -> float:
        """P(qubit q = 1)."""
        pauli = "".join("Z" if i == q else "I" for i in range(self.n))
        return (1.0 - self.expectation(pauli)) / 2.0

    def measure_qubit(self, q: int) -> int:
        """Projective mid-circuit measurement: draw, project, renormalise."""
        p1 = min(max(self.prob_one(q), 0.0), 1.0)
        out = int(torch.rand((), generator=self.gen, dtype=torch.float64).item() < p1)
        proj = np.zeros((2, 2), dtype=complex)
        proj[out, out] = 1.0
        self._apply_1q(proj, q)
        nrm = self.norm()
        if nrm < 1e-15:
            raise FloatingPointError("measurement collapsed to zero norm")
        self._scale_site(self.center, 1.0 / nrm)
        return out

    def measure_qubits(self, qubits) -> list[int]:
        return [self.measure_qubit(q) for q in qubits]

    def reset(self, q: int) -> None:
        """Project qubit q onto |0> and renormalise: the reference's reset
        (Simulation.hs:146-156; an entangled partner collapses consistently
        with 0, never by a Born draw). A |1>-certain qubit (zero-norm
        projection) falls back to the physical measure-then-X-flip reset."""
        proj = np.zeros((2, 2), dtype=complex)
        proj[0, 0] = 1.0
        sites, center = self.sites, self.center     # every op replaces sites
        self._apply_1q(proj, q)
        nrm = self.norm()
        if nrm < 1e-15:
            self.sites, self.center = sites, center
            self._apply_1q(_PAULI["X"], q)
            return
        self._scale_site(self.center, 1.0 / nrm)

    def entanglement_entropy(self, bond: int) -> float:
        """Von Neumann entropy (nats) across the cut between qubit ``bond``
        and ``bond+1``."""
        if not 0 <= bond < self.n - 1:
            raise ValueError("bond out of range")
        self._move_center(bond)
        chi = self.chi
        a = self.sites[bond].cpu().numpy().astype(np.complex128)
        s = np.linalg.svd(a.reshape(chi * 2, chi), compute_uv=False)
        p = s * s
        tot = p.sum()
        if tot <= 0:
            return 0.0
        p = p[p > 1e-14] / tot
        return float(-(p * np.log(p)).sum())
