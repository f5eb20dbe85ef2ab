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
from ..utils import profiling
from . import kernels
from .apply import to_device, to_host


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


def _run_view(n: int, measured):
    """(view shape, axes to sum) of a 2^n vector for a marginal table over
    ``measured``: one axis per run of measured / unmeasured qubits."""
    runs: list[list] = []  # [log2 size, measured?]
    for q in range(n):
        keep = q in measured
        if runs and runs[-1][1] == keep:
            runs[-1][0] += 1
        else:
            runs.append([1, keep])
    return ([1 << size for size, _ in runs],
            [a for a, (_, keep) in enumerate(runs) if not keep])


def marginal_table(state: torch.Tensor, n: int, measured) -> np.ndarray:
    """|a|^2 summed over the unmeasured qubits: a (2^k,) float64 host table,
    bit order = sorted(measured), MSB = smallest qubit."""
    return to_host(marginal_table_dev(state, n, measured).double())


def marginal_table_dev(state: torch.Tensor, n: int, measured) -> torch.Tensor:
    """:func:`marginal_table` as a (2^k,) float32 tensor on the state's
    device, with no host read (the counterpart of the JAX package's
    ``_marginal_table_traced``): one reduction that reads the state once
    (the squared 2-norm over the unmeasured axes) and writes 2^k values.
    Contiguous runs of measured / unmeasured qubits are grouped, so the view
    has one axis per run."""
    shape, drop = _run_view(n, measured)
    view = state.view(shape)
    if not drop:
        return view.abs().square_().reshape(-1)
    return torch.linalg.vector_norm(view, dim=drop).square_().reshape(-1)


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


# ---------------------------------------------------------------------------
# Without host reads: a batch of trajectories, and device-side draws
# ---------------------------------------------------------------------------
#
# The trajectory engines keep every outcome on the device: a batch (T, 2^n)
# of states measures with a per-row outcome tensor, and a single state's
# draws, projections and creg bits are 0-d tensors, so a run of kernels and
# measurements never waits for the host.


def _batch_halves(psi: torch.Tensor, q: int, n: int) -> torch.Tensor:
    """(T, 2^q, 2, 2^(n-1-q)) view of a (T, 2^n) batch: axis 2 is qubit q."""
    return psi.view(psi.shape[0], 1 << q, 2, 1 << (n - 1 - q))


def prob_one_batch(psi: torch.Tensor, q: int, n: int) -> torch.Tensor:
    """(T,) float32 Born probabilities that qubit q reads 1, one per row of a
    (T, 2^n) batch (the counterpart of ``prob_one_traced`` under vmap)."""
    r = torch.view_as_real(_batch_halves(psi, q, n)[:, :, 1, :])
    return (r * r).sum(dim=(1, 2, 3))


def collapse_batch(psi: torch.Tensor, outcome: torch.Tensor, q: int, n: int) -> torch.Tensor:
    """Each row of a (T, 2^n) batch projected onto its ``outcome`` (a (T,)
    int tensor, or an int) for qubit q and renormalized, as a new tensor (the
    counterpart of ``collapse_traced`` under vmap). A row whose projection
    has no norm becomes the zero vector."""
    v = _batch_halves(psi, q, n)
    side = torch.arange(2, device=psi.device)
    out = torch.as_tensor(outcome, device=psi.device).reshape(-1, 1)
    sel = (side[None, :] == out)[:, None, :, None]
    m = torch.where(sel, v, torch.zeros((), dtype=v.dtype, device=v.device))
    r = torch.view_as_real(m)
    nrm = torch.sqrt((r * r).sum(dim=(1, 2, 3, 4)))
    scale = 1.0 / torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    return (m * scale[:, None, None, None]).reshape(psi.shape)


def bit_table(k: int, device) -> torch.Tensor:
    """(k, 2^k) float32: row s is bit s (MSB first) of each table index."""
    idx = np.arange(1 << k, dtype=np.int64)
    bits = np.stack([(idx >> (k - 1 - s)) & 1 for s in range(k)]).astype(np.float32)
    return torch.from_numpy(bits.reshape(k, 1 << k)).to(device)


def ancestral_draws_dev(table: torch.Tensor, qubits, uniforms: torch.Tensor,
                        bits: torch.Tensor):
    """:func:`ancestral_draws` on a device table with device uniforms (the
    counterpart of ``_ancestral_draws_traced`` with operand uniforms):
    returns (outcomes, a list of 0-d float32 tensors in ``qubits`` order, and
    the (2^k,) mask of the drawn outcome). ``bits`` is :func:`bit_table` of
    k on the table's device. The Born rule is the correct one."""
    srt = sorted(qubits)
    mask = torch.ones_like(table)
    outcomes = []
    for i, q in enumerate(qubits):
        b1 = bits[srt.index(q)]
        masked = table * mask
        tot = masked.sum()
        p1 = torch.where(tot > 0, (masked * b1).sum() / tot, torch.zeros_like(tot))
        o = (uniforms[i] < p1).to(table.dtype)
        outcomes.append(o)
        mask = mask * (b1 * o + (1.0 - b1) * (1.0 - o))
    return outcomes, mask


class Projector:
    """The joint projection of ``qubits`` on a 2^n state as a row indicator
    times a column indicator over a (2^(n-c), 2^c) view, c = min(n, 15), with
    the outcomes and the scale given as device tensors (the counterpart of
    ``_projection_rowcol_traced``): no host read and no state-sized temp."""

    def __init__(self, qubits, n: int, device):
        self.n = n
        self.c = min(n, 15)
        ridx = np.arange(1 << (n - self.c), dtype=np.int64)
        cidx = np.arange(1 << self.c, dtype=np.int64)
        self.parts = []  # (on the rows?, indicator of bit = 1)
        for q in qubits:
            pos = n - 1 - q
            rows = pos >= self.c
            b = ((ridx >> (pos - self.c)) & 1) if rows else ((cidx >> pos) & 1)
            self.parts.append((rows, torch.from_numpy(b.astype(np.float32)).to(device)))

    def vectors(self, outcomes, scale: torch.Tensor):
        """(row vector times ``scale``, column vector) for the outcomes."""
        dev = scale.device
        rowvec = scale.reshape(1).expand(1 << (self.n - self.c)).clone()
        colvec = torch.ones(1 << self.c, dtype=torch.float32, device=dev)
        for (rows, b), o in zip(self.parts, outcomes):
            f = b * o + (1.0 - b) * (1.0 - o)
            if rows:
                rowvec = rowvec * f
            else:
                colvec = colvec * f
        return rowvec, colvec

    def apply(self, state: torch.Tensor, rowvec: torch.Tensor, colvec: torch.Tensor):
        """Multiply the state by the indicators, in place."""
        view = state.view(1 << (self.n - self.c), 1 << self.c)
        view.mul_(rowvec[:, None])
        view.mul_(colvec[None, :])
        return state


def probabilities(state: torch.Tensor) -> torch.Tensor:
    """|psi|^2 over the computational basis, float32."""
    p = state.abs()
    return p.mul_(p)


# ---------------------------------------------------------------------------
# Pauli-string expectation values
# ---------------------------------------------------------------------------
#
# P|x> = i^{#Y} s(x) |x ^ f>, f the X/Y bit mask, s(x) = (-1)^popcount(x & z),
# z the Y/Z bit mask. So (P psi)[y] = i^{#Y} s(y ^ f) psi[y ^ f] and
# <psi|P|psi> = Re(i^{#Y} sum_x conj(psi[x ^ f]) s(x) psi[x]). These are
# plain torch ops, as the JAX package's were plain XLA. The state is walked
# in chunks of 2^_EXP_CHUNK indices: the high bits of f pick the partner
# chunk (a view), the low bits are one gather inside it, and the signs are a
# row table times a column table over a (rows, cols) view of the chunk, so
# no state-sized temporary or index tensor is ever made. Every chunk's
# partial sums are float64. On a CUDA device a pair of states on one device
# is reduced instead by the pair kernel (``kernels.pair_sums``) in one pass,
# with no table or index uploaded.

#: log2 of the chunk the expectation functions walk a state in
_EXP_CHUNK = 22
#: log2 of the columns of a chunk's (rows, cols) view
_EXP_COLS = 11


def _check_pauli(pauli: str, n: int) -> str:
    pauli = pauli.upper()
    if len(pauli) != n or any(c not in "IXYZ" for c in pauli):
        raise ValueError(f"Pauli string must be {n} chars of I/X/Y/Z: {pauli!r}")
    return pauli


def _apply_iy(tr: float, ti: float, n_y: int) -> complex:
    return complex(tr, ti) * (1j ** (n_y % 4))


def pauli_masks(pauli: str) -> tuple[int, int, int]:
    """(flip mask, sign mask, #Y) of a checked Pauli string as amplitude
    index bits: qubit q is bit n-1-q."""
    n = len(pauli)
    f = z = 0
    for q, c in enumerate(pauli):
        if c in "XY":
            f |= 1 << (n - 1 - q)
        if c in "YZ":
            z |= 1 << (n - 1 - q)
    return f, z, pauli.count("Y")


def _parity_sign(idx: np.ndarray, mask: int) -> np.ndarray:
    """(-1)^popcount(idx & mask) as float64, for int64 ``idx``."""
    x = idx & mask
    for s in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return 1.0 - 2.0 * (x & 1).astype(np.float64)


def _chunk_shape(n: int, chunk: int | None = None) -> tuple[int, int, int]:
    """(c, lr, lc): a state of n qubits is walked in chunks of 2^c indices
    (c at most ``chunk``, default ``_EXP_CHUNK``), each viewed as (2^lr, 2^lc)."""
    c = min(n, _EXP_CHUNK if chunk is None else chunk)
    lc = min(c, _EXP_COLS)
    return c, c - lc, lc


def _walk(n: int, f: int, zs, dev, chunk: int | None = None):
    """What a chunked walk of a 2^n state needs for the flip mask ``f`` and
    the sign masks ``zs``: (c, lr, lc), the flip's chunk part, the gather
    index of its in-chunk part on ``dev`` (None when it has none; its upload
    counts as a sync), and the float64 sign tables of each mask as numpy
    arrays: rows (k, 2^lr), columns (k, 2^lc) and chunks (2^(n-c), k).
    ``chunk`` is as :func:`_chunk_shape` takes it."""
    c, lr, lc = _chunk_shape(n, chunk)
    f_lo = f & ((1 << c) - 1)
    gather = None
    if f_lo:
        gather = to_device(np.arange(1 << c, dtype=np.int64) ^ f_lo, dev)
    ridx = np.arange(1 << lr, dtype=np.int64)
    cidx = np.arange(1 << lc, dtype=np.int64)
    hidx = np.arange(1 << (n - c), dtype=np.int64)
    srows = np.stack([_parity_sign(ridx, (z >> lc) & ((1 << lr) - 1)) for z in zs])
    scols = np.stack([_parity_sign(cidx, z & ((1 << lc) - 1)) for z in zs])
    shi = np.stack([_parity_sign(hidx, z >> c) for z in zs], axis=1)
    return (c, lr, lc), f >> c, gather, srows, scols, shi


def pauli_pair_sums(a: torch.Tensor, b: torch.Tensor, n: int, f: int, zs,
                    out: torch.Tensor | None = None) -> np.ndarray | None:
    """sum_x conj(b[x ^ f]) s_z(x) a[x] for every sign mask z in ``zs``: a
    host complex128 array of len(zs), without the i^{#Y} factors. ``a`` and
    ``b`` are 2^n complex64 tensors; ``b is a`` for a single state, and a
    partner buffer on the mesh path, which may lie on another device and is
    then copied over one chunk at a time. With ``out``, a float64
    (len(zs), 2) tensor on ``a``'s device, the sums' real and imaginary
    parts are added into it instead and nothing is returned or read back.

    Two states on one CUDA device go through the pair kernel
    (``kernels.pair_sums``); otherwise the states are walked chunk by chunk
    (:func:`pair_walk`). Each call counts one ``pair_walks``; its copies
    between host and device (the walk's sign tables and gather index, the
    sums' read-back) count as ``syncs``."""
    profiling.count("pair_walks")
    zs = [int(z) for z in zs]
    if a.device.type == "cuda" and b.device == a.device:
        acc = out if out is not None else torch.zeros(len(zs), 2, dtype=torch.float64,
                                                      device=a.device)
        kernels.pair_sums(a, b, f, zs, acc, n)
        if out is not None:
            return None
        s = to_host(acc)
    else:
        s = pair_walk(a, b, n, f, zs)
        if out is not None:
            out.add_(to_device(s, out.device))
            return None
    if b is a and f == 0:
        return s[:, 0].astype(np.complex128)
    return s[:, 0] + 1j * s[:, 1]


def pair_walk(a: torch.Tensor, b: torch.Tensor, n: int, f: int, zs) -> np.ndarray:
    """The sums of :func:`pauli_pair_sums` by a walk of the states in chunks
    of 2^_EXP_CHUNK indices, in torch ops on any device: a float64 (len(zs),
    2) host array of real and imaginary parts. All the terms of one flip
    mask share the partner read and the product; a no-flip walk of one state
    reads |a|^2 once, and its imaginary parts are 0."""
    zs = [int(z) for z in zs]
    kg = len(zs)
    dev = a.device
    (c, lr, lc), f_hi, gather, srows, scols, shi = _walk(n, f, zs, dev)
    srows, scols, shi = (to_device(t, dev) for t in (srows, scols, shi))
    diagonal = b is a and f == 0
    av = a.view(-1, 1 << c)
    bv = b.view(-1, 1 << c)
    width = 1 if diagonal else 2
    acc = torch.zeros(kg, width, dtype=torch.float64, device=dev)
    for h in range(av.shape[0]):
        ac = av[h]
        if diagonal:
            t = ac.abs().double()
            t.mul_(t)
        else:
            bc = bv[h ^ f_hi]
            if bc.device != dev:  # a partner bank on another device of a mesh
                bc = bc.to(dev)
            if gather is not None:
                bc = bc[gather]
            t = torch.view_as_real(torch.conj_physical(bc).mul_(ac)).double()
        # sum over the rows with each term's row signs, then over the
        # columns with its column signs
        part = (srows @ t.view(1 << lr, -1)).view(kg, 1 << lc, width)
        part = (part * scols[:, :, None]).sum(dim=1)
        acc.addcmul_(part, shi[h][:, None])
    out = to_host(acc)
    if diagonal:
        return np.concatenate([out, np.zeros_like(out)], axis=1)
    return out


def expectation_pauli(state: torch.Tensor, n: int, pauli: str) -> float:
    """<psi|P|psi> for a Pauli string like "XZIIY" (len n; I/X/Y/Z, qubit 0
    leftmost) as one chunked reduction, with no dense operator. Hermitian,
    so the result is real (the imaginary part is numerical noise)."""
    pauli = _check_pauli(pauli, n)
    f, z, n_y = pauli_masks(pauli)
    s = pauli_pair_sums(state, state, n, f, (z,))[0]
    return float(_apply_iy(s.real, s.imag, n_y).real)


def group_terms(paulis) -> dict[int, list[int]]:
    """Indices of checked Pauli strings grouped by their X/Y flip mask, in
    order of first appearance."""
    groups: dict[int, list[int]] = {}
    for j, p in enumerate(paulis):
        groups.setdefault(pauli_masks(p)[0], []).append(j)
    return groups


def expectation_pauli_sum(state: torch.Tensor, n: int, terms) -> float:
    """<psi| sum_j c_j P_j |psi> for ``terms = [(coef, pauli), ...]``. Terms
    are grouped by their X/Y flip mask: a group shares one partner read, and
    a whole diagonal (Ising/QAOA) Hamiltonian is one pass over |psi|^2."""
    paulis = [_check_pauli(p, n) for _, p in terms]
    total = 0.0
    for f, idxs in group_terms(paulis).items():
        sums = pauli_pair_sums(state, state, n, f,
                               [pauli_masks(paulis[j])[1] for j in idxs])
        for s, j in zip(sums, idxs):
            total += terms[j][0] * _apply_iy(s.real, s.imag, paulis[j].count("Y")).real
    return float(total)


def apply_pauli(state: torch.Tensor, pauli: str, n: int) -> torch.Tensor:
    """P|psi> as a new tensor (the counterpart of the JAX package's
    ``apply_pauli_traced``): out[y] = i^{#Y} s(y ^ f) psi[y ^ f]
    = (-i)^{#Y} s(y) psi[y ^ f], since s(y ^ f) = s(y) s(f) and
    s(f) = (-1)^{#Y}."""
    pauli = _check_pauli(pauli, n)
    f, z, n_y = pauli_masks(pauli)
    dev = state.device
    (c, lr, lc), f_hi, gather, srows, scols, shi = _walk(n, f, (z,), dev)
    phase = (-1j) ** (n_y % 4)
    srow = torch.from_numpy(srows[0].astype(np.float32)).to(dev)[:, None]
    scol = torch.from_numpy(scols[0].astype(np.float32)).to(dev)[None, :]
    out = torch.empty_like(state)
    sv = state.view(-1, 1 << c)
    ov = out.view(-1, 1 << lr, 1 << lc)
    for h in range(sv.shape[0]):
        src = sv[h ^ f_hi]
        src = src[gather] if gather is not None else src
        torch.mul(src.view(1 << lr, 1 << lc), srow, out=ov[h])
        ov[h].mul_(scol).mul_(complex(phase * shi[h, 0]))
    return out


def apply_pauli_sum(state: torch.Tensor, terms, n: int) -> torch.Tensor:
    """(sum_j c_j P_j)|psi> as a new tensor (the counterpart of the JAX
    package's ``apply_pauli_sum_traced``): each term's :func:`apply_pauli`
    added into one accumulator, so one state-sized temporary is live beside
    it."""
    acc = None
    for coef, pauli in terms:
        term = apply_pauli(state, pauli, n)
        acc = term.mul_(coef) if acc is None else acc.add_(term, alpha=coef)
    if acc is None:
        return torch.zeros_like(state)
    return acc
