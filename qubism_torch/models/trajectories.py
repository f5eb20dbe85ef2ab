"""Quantum-trajectory (Monte-Carlo wavefunction) noise simulation.

Counterpart of qubism_tpu/models/trajectories.py. Kraus noise channels
unravel into stochastic pure-state evolution: a batch of T trajectories is
ONE (T, 2^n) complex64 tensor (the JAX package's ``vmap`` axis is its
leading dimension), every gate applies to all rows at once through the
out-of-place batched appliers below, and each :class:`ChannelOp` samples one
Kraus branch per row (branch probability = its squared norm, the standard
MCWF rule) and renormalizes. Averaging an observable over trajectories
converges to the exact :class:`~qubism_torch.core.density.DensityMatrix`
value at memory T * 2^n instead of 4^n.

Randomness: the JAX package derives a channel's uniform from
``fold_in(key, item index)``. Here each trajectory takes one row of a
(T, S) float64 uniform table, S = the program's stochastic items in order,
drawn up front from a seeded CPU ``torch.Generator``; ``uniforms=`` replaces
the table (the tests inject the JAX package's own draws). The branch choice
never reads the host: norms, CDFs and the one-hot blend stay on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.gates import Gate, Prim
from ..ops import apply as A
from ..ops import measure as M

__all__ = [
    "ChannelOp",
    "trajectory_state_fn",
    "run_trajectories",
    "trajectory_expectation",
    "trajectory_pauli_sum",
    "trajectory_probs",
    "trajectory_sample",
]


@dataclass(frozen=True)
class ChannelOp:
    """A Kraus channel {K_k} on explicit targets, for trajectory programs.

    ``kraus`` is a sequence of (2^k, 2^k) complex matrices with
    sum_k K_k^dag K_k = I (checked); ``targets[0]`` is the most
    significant bit of the local index, matching :class:`Prim`.
    """

    kraus: tuple
    targets: tuple

    def __init__(self, kraus, targets):
        ks = tuple(np.asarray(k, dtype=np.complex128) for k in kraus)
        tgts = tuple(int(t) for t in targets)
        d = 1 << len(tgts)
        tot = sum(k.conj().T @ k for k in ks)
        if ks[0].shape != (d, d):
            raise ValueError(
                f"Kraus shape {ks[0].shape} does not match {len(tgts)} targets")
        if not np.allclose(tot, np.eye(d), atol=1e-8):
            raise ValueError("Kraus operators do not sum to identity (CPTP)")
        object.__setattr__(self, "kraus", ks)
        object.__setattr__(self, "targets", tgts)

    def shifted(self, offset: int) -> "ChannelOp":
        return ChannelOp(self.kraus, tuple(t + offset for t in self.targets))


def _unitary_mix(kraus):
    """Host-side probe: if EVERY Kraus operator of a channel is a scaled
    unitary (K^dag K = p I: all Pauli / mixed-unitary channels: dep, dep2,
    bf, pf), the branch probabilities are state-independent, so a
    trajectory draws the branch from a static CDF and applies ONE small
    unitary instead of one full-state application per branch. Returns
    ``(cdf, mats)``: the float32 (k,) CDF and the complex64 (k, d, d) branch
    unitaries, or ``None`` when the channel needs the state-dependent MCWF
    weights (amplitude/phase damping)."""
    probs, us = [], []
    for k in kraus:
        k = np.asarray(k, dtype=np.complex128)
        g = k.conj().T @ k
        p = float(np.real(np.trace(g))) / g.shape[0]
        if p < 1e-12 or not np.allclose(g, p * np.eye(g.shape[0]), atol=1e-9):
            return None
        probs.append(p)
        us.append(k / np.sqrt(p))
    cdf = np.cumsum(np.asarray(probs, dtype=np.float32))
    return cdf, np.stack(us).astype(np.complex64)


def _elaborate(program):
    """Flatten Gates to prims; pre-sort channel Kraus matrices to sorted
    target order (host-side, once). A channel becomes ("umix", (cdf, mats),
    targets) or ("channel", kraus (k, d, d) complex64, targets)."""
    items = []
    for it in program:
        if isinstance(it, ChannelOp):
            sorted_ks, tgts = [], None
            for k in it.kraus:
                un, tgts = A._sort_targets(k, it.targets)
                sorted_ks.append(un)
            mix = _unitary_mix(sorted_ks)
            if mix is not None:
                items.append(("umix", mix, tgts))
            else:
                items.append(("channel", np.stack(sorted_ks).astype(np.complex64), tgts))
        elif isinstance(it, Gate):
            items.extend(it.prims)
        elif isinstance(it, Prim):
            items.append(it)
        else:
            raise TypeError(f"trajectory program item: {type(it).__name__}")
    return items


# ---------------------------------------------------------------------------
# Batched out-of-place appliers
# ---------------------------------------------------------------------------

#: the least tail (amplitudes below a 1q gate's qubit) at which the gate
#: multiplies the (rest, 2, tail) view in place of moving its axis last
_DIRECT_TAIL = 1 << 10


def apply_dense_batch(psi: torch.Tensor, u: torch.Tensor, targets, n: int) -> torch.Tensor:
    """U times every row of a (T, 2^n) batch, as a new tensor: ``u`` a
    complex64 (2^k, 2^k) tensor, or (T, 2^k, 2^k) for one matrix per row, on
    sorted ``targets`` (targets[0] = MSB). The target axes are moved last and
    contracted with one (batched) matmul; a 1q gate whose qubit has at least
    2^10 amplitudes below it multiplies the (rest, 2, tail) view directly,
    with no copy to move the axis."""
    t = psi.shape[0]
    d = 1 << len(targets)
    tail = 1 << (n - 1 - targets[0])
    if d == 2 and tail >= _DIRECT_TAIL:
        x = psi.view(t, -1, 2, tail)
        return torch.matmul(u if u.dim() == 2 else u[:, None], x).reshape(t, -1)
    dims, axes = A.target_view(n, tuple(targets))
    rest = [a for a in range(len(dims)) if a not in axes]
    perm = [0] + [1 + a for a in rest] + [1 + a for a in axes]
    x = psi.view(t, *dims).permute(perm).reshape(t, -1, d)
    y = torch.matmul(x, u.transpose(-1, -2))
    inv = [perm.index(a) for a in range(len(dims) + 1)]
    return y.view([t] + [dims[a] for a in rest] + [2] * len(axes)).permute(inv).reshape(t, -1)


def apply_diag_batch(psi: torch.Tensor, d: torch.Tensor, targets, n: int) -> torch.Tensor:
    """The diagonal ``d`` (2^k,) on ``targets`` (any order) times every row,
    as a new tensor: one broadcast multiply over the target axes."""
    k = len(targets)
    order = sorted(range(k), key=lambda j: targets[j])
    table = d.reshape((2,) * k).permute(order) if k else d
    dims, axes = A.target_view(n, tuple(sorted(targets)))
    shape = [1] * len(dims)
    for a in axes:
        shape[a] = 2
    return (psi.view(psi.shape[0], *dims) * table.reshape([1] + shape)).reshape(psi.shape)


def apply_prim_batch(psi: torch.Tensor, p: Prim, n: int) -> torch.Tensor:
    """One prim on every row of the batch, out of place."""
    if p.diag:
        return apply_diag_batch(psi, A.as_operand(p.u, psi), p.targets, n)
    u, srt = A._sort_targets(np.asarray(p.u, dtype=np.complex128), tuple(p.targets))
    return apply_dense_batch(psi, A.as_operand(u, psi), srt, n)


def apply_unitary_mix_batch(psi: torch.Tensor, mix, targets, n: int,
                            u: torch.Tensor) -> torch.Tensor:
    """A mixed-unitary channel: each row draws its branch j from the static
    float32 CDF with its uniform (``u`` (T,) float32), and the row's one
    branch unitary is applied (a unitary keeps the norm: no renormalizing
    sweep)."""
    cdf, mats = mix
    cdf = torch.from_numpy(np.asarray(cdf, dtype=np.float32)).to(psi.device)
    j = torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)
    return apply_dense_batch(psi, A.as_operand(mats, psi).index_select(0, j), targets, n)


def apply_channel_batch(psi: torch.Tensor, kraus, targets, n: int,
                        u: torch.Tensor) -> torch.Tensor:
    """Each row samples one Kraus branch (probability = squared norm of
    K_k|psi>, drawn with its uniform ``u``) and is renormalized. Every
    branch is computed; the choice is a one-hot blend on the device, as the
    JAX package's, so nothing is read back: the one-hot weights pick each
    row's branch by ``torch.where`` (a sum of one branch times 1 and the
    others times 0 is that branch), and each norm is one read of its
    branch."""
    ks = A.as_operand(kraus, psi)
    branches = [apply_dense_batch(psi, k, targets, n) for k in ks]
    norms = torch.stack([torch.linalg.vector_norm(b, dim=1).square_() for b in branches],
                        dim=1)  # (T, B)
    cdf = torch.cumsum(norms, dim=1)
    j = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)
    j = j.clamp_(max=len(branches) - 1)
    w = (torch.arange(len(branches), device=psi.device)[None, :] == j).to(torch.float32)
    out = branches[-1]
    for k in range(len(branches) - 2, -1, -1):
        out = torch.where(w[:, k, None] > 0, branches[k], out)
    scale = torch.rsqrt(torch.clamp((w * norms).sum(dim=1), min=1e-30))
    return out.mul_(scale[:, None])


def _zero_batch(t: int, n: int, dev) -> torch.Tensor:
    psi = torch.zeros((t, 1 << n), dtype=torch.complex64, device=dev)
    psi[:, 0].fill_(1)
    return psi


def uniform_table(ntraj: int, sites: int, seed: int | None = 0) -> torch.Tensor:
    """The (T, S) float64 uniform table of a trajectory batch, from a CPU
    generator seeded with ``seed``. The first T rows do not depend on how
    many rows are drawn after them."""
    gen = torch.Generator().manual_seed(0 if seed is None else int(seed))
    return torch.rand((ntraj, sites), generator=gen, dtype=torch.float64)


def trajectory_state_fn(n: int, program):
    """``uniforms -> states``: ``uniforms`` a (T, S) float table (S = the
    program's channels, in order; row t drives trajectory t) and the result
    the (T, 2^n) complex64 batch of final states on ``config.device``."""
    items = _elaborate(program)

    def run(uniforms) -> torch.Tensor:
        dev = A.device()
        u = torch.as_tensor(uniforms).to(device=dev, dtype=torch.float32)
        psi = _zero_batch(u.shape[0], n, dev)
        site = 0
        for item in items:
            if isinstance(item, tuple):
                kind, kp, tgts = item
                apply = apply_unitary_mix_batch if kind == "umix" else apply_channel_batch
                psi = apply(psi, kp, tgts, n, u[:, site].contiguous())
                site += 1
            else:
                psi = apply_prim_batch(psi, item, n)
        return psi

    run.sites = sum(1 for it in items if isinstance(it, tuple))
    return run


def run_trajectories(n: int, program, ntraj: int, seed: int = 0, uniforms=None) -> torch.Tensor:
    """Evolve ``ntraj`` trajectories of ``program`` (Prims/Gates mixed with
    ChannelOps) as one batch. Returns the (T, 2^n) complex64 final states.
    ``uniforms`` ((T, S) floats) replaces the seeded table."""
    fn = trajectory_state_fn(n, program)
    if uniforms is None:
        uniforms = uniform_table(ntraj, fn.sites, seed)
    return fn(uniforms)


def _mean_stderr(vals) -> tuple[float, float]:
    vals = np.asarray(vals, dtype=np.float64)
    t = vals.shape[0]
    se = float(vals.std(ddof=1) / math.sqrt(t)) if t > 1 else float("inf")
    return float(vals.mean()), se


def pauli_values(psi: torch.Tensor, n: int, paulis) -> np.ndarray:
    """(T, k) float64: <P_j> on each row of the batch for checked Pauli
    strings, through the chunked reductions of ops/measure.py (terms of one
    flip mask share a walk)."""
    out = np.zeros((psi.shape[0], len(paulis)))
    groups = M.group_terms(paulis)
    for t in range(psi.shape[0]):
        row = psi[t]
        for f, idxs in groups.items():
            sums = M.pauli_pair_sums(row, row, n, f, [M.pauli_masks(paulis[j])[1] for j in idxs])
            for s, j in zip(sums, idxs):
                out[t, j] = M._apply_iy(s.real, s.imag, paulis[j].count("Y")).real
    return out


def trajectory_expectation(psi: torch.Tensor, pauli: str, n: int):
    """Monte-Carlo estimate of <P>: (mean, standard error) over the
    trajectory batch."""
    pauli = M._check_pauli(pauli, n)
    return _mean_stderr(pauli_values(psi, n, [pauli])[:, 0])


def trajectory_pauli_sum(psi: torch.Tensor, terms, n: int, constant: float = 0.0):
    """Monte-Carlo <H> for H = sum coef * P + constant: the per-trajectory
    energies are summed first, so the standard error accounts for
    cross-term correlations."""
    checked = [(float(c), M._check_pauli(p, n)) for c, p in terms]
    vals = pauli_values(psi, n, [p for _, p in checked])
    mean, se = _mean_stderr(vals @ np.asarray([c for c, _ in checked]))
    return mean + constant, se


def trajectory_sample(psi: torch.Tensor, seed: int = 0, uniforms=None) -> np.ndarray:
    """One full-register measurement record per trajectory (the standard
    MCWF readout). Returns (T, n) uint8, column q = qubit q (qubit 0 = most
    significant basis bit). One batched inverse-CDF search; ``uniforms`` ((T,)
    floats in [0, 1)) replaces the seeded draws."""
    t, size = psi.shape
    n = size.bit_length() - 1
    u = M.draw(torch.Generator().manual_seed(int(seed)), t, uniforms)
    r = torch.view_as_real(psi)
    cdf = torch.cumsum((r * r).sum(dim=-1), dim=1)
    target = torch.from_numpy(u.astype(np.float32)).to(psi.device) * cdf[:, -1]
    # clamp: u * total can round up to >= total in float32
    idx = torch.searchsorted(cdf, target[:, None], right=True).clamp_(max=size - 1)
    idx = idx[:, 0].cpu().numpy().astype(np.int64)
    shifts = n - 1 - np.arange(n)
    return ((idx[:, None] >> shifts[None, :]) & 1).astype(np.uint8)


def trajectory_probs(psi: torch.Tensor) -> np.ndarray:
    """Trajectory-averaged Born probabilities (the diagonal of the estimated
    rho): (2^n,) float64. Converges to DensityMatrix.probs()."""
    r = torch.view_as_real(psi)
    return (r * r).sum(dim=-1).mean(dim=0).double().cpu().numpy()
