"""Stabilizer-tableau (Clifford) simulation engine.

Counterpart of qubism_tpu/stabilizer/tableau.py: the Aaronson-Gottesman
destabilizer/stabilizer tableau (arXiv:quant-ph/0406196) as bit-packed
planes, so Clifford circuits on thousands of qubits take O(n^2) bits.

* **Planes.** ``x`` and ``z`` are ``(2n, W)`` ``torch.int32`` tensors
  (``W = ceil(n/32)``), ``s`` a ``(2n,)`` int32 phase mod 4. Row r is the
  Pauli ``i^s X^x Z^z``; qubit q is bit ``q & 31`` of word ``q >> 5``, the
  JAX package's uint32 layout bit for bit (:func:`tableau_from_planes` /
  :func:`planes_from_tableau` view it as uint32 at the boundary). int32,
  not uint32: torch's uint32 has no shifts, comparisons, gather or
  indexed writes. ``(w >> off) & 1`` reads a bit under the arithmetic
  shift, and :func:`_popcount` masks after every shift. Every function
  also takes a batch of tableaux, ``(T, 2n, W)`` planes (the trajectory
  engine of noise.py).
* **Gates.** A k-qubit Clifford prim is characterized on the host by its
  conjugation table (:func:`clifford_tables`). Applying it reads each
  row's 2k target bits, gathers one packed table entry (the x and z bits
  to flip and the phase to add) and XORs the flips into the target
  columns. The chain is walked on the host: targets, words and offsets are
  Python ints, so a step launches only its own ~36 elementwise ops (an
  identity prim none). A run of prims on disjoint qubits (a CX fan, a 1q
  layer) is one step of ~37 ops, whatever its width.
* **Measurement** never loops over rows in Python. The product of the
  selected stabilizer rows that decides a deterministic outcome has the
  phase ``sel.s + 2 sel.triu(C,1).sel`` with ``C[j,i] = popcount(z_j &
  x_i)`` (three float32 matmuls, :func:`det_outcomes`), or, for one
  selection, ``sum_i sel_i (s_i + 2 popcount(prefix_i & x_i))`` with the
  exclusive prefix XOR of the selected z rows taken in log2(n) doubling
  steps. A register is read in rounds: the first qubit still left that is
  random (one host read), every deterministic qubit before it in one
  batch, the random branch for it; so GHZ-n reads in 2 rounds.
* **Matmul exactness.** The GF(2) products run in float32 with no
  autocast: every operand is 0..3, exact in fp32, TF32 and bf16, and every
  accumulator stays below 2^24 (at most 3n^2 in the readout, guarded by
  ``_DET_BATCH_MAX_N``; at most R <= n in the sampler), so the result is
  exact whether or not ``torch.backends.cuda.matmul.allow_tf32`` is set.

Random bits come from explicit ``torch.Generator``s; the functions that
consume them take them as arguments (``measure_seq``'s ``rnd_bits``,
``affine_sample``'s ``r``), as the JAX package's do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.apply import device

__all__ = [
    "NotCliffordError",
    "Tableau",
    "identity_tableau",
    "tableau_from_planes",
    "planes_from_tableau",
    "apply_prims",
    "affine_support",
    "det_outcomes",
    "measure_qubit",
    "measure_seq",
    "affine_sample",
    "sample_bits",
    "expectation",
    "stabilizer_strings",
    "clifford_tables",
    "StabilizerSim",
    "stats",
]


class NotCliffordError(ValueError):
    """Raised when a primitive does not normalize the Pauli group."""


#: host reads of device values (each synchronises with the card) and
#: measurement rounds, since the last :func:`reset_stats`
stats = {"syncs": 0, "rounds": 0}


def reset_stats():
    stats["syncs"] = stats["rounds"] = 0


def _host(t: torch.Tensor):
    """A device tensor's values as Python data, counted as a sync."""
    stats["syncs"] += 1
    return t.tolist()


# -- host-side Clifford characterization --------------------------------------

_I2 = np.eye(2, dtype=np.complex128)
_X2 = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_Z2 = np.array([[1, 0], [0, -1]], dtype=np.complex128)
_ID4 = np.eye(4, dtype=np.complex128)


def _w_matrix(c: int, k: int) -> np.ndarray:
    """Dense ``X^x Z^z`` for pattern ``c`` (bit 2j = x_j, bit 2j+1 = z_j);
    factor j=0 is the MOST significant kron factor (targets[0] = MSB)."""
    m = np.eye(1, dtype=np.complex128)
    for j in range(k):
        xj = (c >> (2 * j)) & 1
        zj = (c >> (2 * j + 1)) & 1
        m = np.kron(m, (_X2 if xj else _I2) @ (_Z2 if zj else _I2))
    return m


def _w_inverse(c: int, k: int) -> np.ndarray:
    """(X^x Z^z)^{-1} = Z^z X^x per factor."""
    m = np.eye(1, dtype=np.complex128)
    for j in range(k):
        xj = (c >> (2 * j)) & 1
        zj = (c >> (2 * j + 1)) & 1
        m = np.kron(m, (_Z2 if zj else _I2) @ (_X2 if xj else _I2))
    return m


_TABLE_CACHE: dict = {}


def clifford_tables(u: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Characterize a dense 2^k x 2^k unitary by conjugation: for each of
    the 4^k Pauli patterns ``c`` on its targets, ``U W(c) U^dag = i^ds
    W(c')``. Returns (tx, tz, ts) uint32: tx[c]/tz[c] pack the k new x/z
    bits (bit j = target j), ts[c] = ds mod 4. Raises NotCliffordError when
    any image is not a single Pauli with a unit fourth-root coefficient."""
    u = np.asarray(u, dtype=np.complex128)
    key = (u.shape[0], u.tobytes())
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    dim = u.shape[0]
    k = dim.bit_length() - 1
    if dim != (1 << k):
        raise ValueError(f"not a 2^k x 2^k matrix: {u.shape}")
    ncfg = 4 ** k
    ws = [_w_matrix(c, k) for c in range(ncfg)]
    winv = [_w_inverse(c, k) for c in range(ncfg)]
    tx = np.zeros(ncfg, dtype=np.uint32)
    tz = np.zeros(ncfg, dtype=np.uint32)
    ts = np.zeros(ncfg, dtype=np.uint32)
    udag = u.conj().T
    if not np.allclose(u @ udag, np.eye(dim), atol=1e-8):
        raise NotCliffordError("matrix is not unitary")
    for c in range(ncfg):
        a = u @ ws[c] @ udag
        for c2 in range(ncfg):
            coef = np.trace(winv[c2] @ a) / dim
            if abs(abs(coef) - 1.0) < 1e-8 and np.allclose(a, coef * ws[c2], atol=1e-8):
                ds = int(np.round(np.angle(coef) / (np.pi / 2))) % 4
                if abs(coef - 1j ** ds) > 1e-8:
                    raise NotCliffordError(
                        f"Pauli image carries non-quarter-turn phase {coef:.6f}")
                for j in range(k):
                    tx[c] |= (((c2 >> (2 * j)) & 1) << j)
                    tz[c] |= (((c2 >> (2 * j + 1)) & 1) << j)
                ts[c] = ds
                break
        else:
            raise NotCliffordError(
                "gate does not map Paulis to Paulis under conjugation "
                "(not a Clifford unitary) — the stabilizer backend supports "
                "H, S, S†, X, Y, Z, CX, CZ, SWAP and any other gate whose "
                "matrix is Clifford; use the state-vector backend for "
                "general circuits")
    _TABLE_CACHE[key] = (tx, tz, ts)
    return tx, tz, ts


# -- the tableau --------------------------------------------------------------


def _words(n: int) -> int:
    return (n + 31) // 32


def _bitval(off: int) -> int:
    """``1 << off`` as an int32 value (bit 31 is the sign bit)."""
    return (1 << off) if off < 31 else -(1 << 31)


class Tableau(NamedTuple):
    """(x, z, s): two (..., 2n, W) int32 bit planes + (..., 2n) int32 phase
    mod 4. Rows [0, n) are destabilizers, rows [n, 2n) stabilizers."""

    x: torch.Tensor
    z: torch.Tensor
    s: torch.Tensor


def identity_tableau(n: int, dev=None, batch: int | None = None) -> Tableau:
    """|0...0>: destabilizer i = X_i, stabilizer i = Z_i, all phases +;
    ``batch`` copies stacked as (batch, 2n, W) planes."""
    w = _words(n)
    x = np.zeros((2 * n, w), dtype=np.uint32)
    z = np.zeros((2 * n, w), dtype=np.uint32)
    for i in range(n):
        x[i, i >> 5] |= np.uint32(1 << (i & 31))
        z[n + i, i >> 5] |= np.uint32(1 << (i & 31))
    tab = tableau_from_planes(x, z, np.zeros(2 * n, dtype=np.uint32), dev)
    if batch is None:
        return tab
    return Tableau(*(t.expand(batch, *t.shape).clone() for t in tab))


def tableau_from_planes(x, z, s, dev=None) -> Tableau:
    """The JAX package's uint32 planes (numpy or anything array-like) ->
    a :class:`Tableau` on ``dev`` (default: the configured device)."""
    dev = device() if dev is None else dev

    def up(a):
        a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
        return torch.from_numpy(a.view(np.int32).copy()).to(dev)

    return Tableau(up(x), up(z), up(s))


def planes_from_tableau(tab: Tableau) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A :class:`Tableau` -> the JAX package's (x, z, s) uint32 numpy
    planes (one device-to-host copy each)."""
    stats["syncs"] += 1
    return tuple(t.cpu().numpy().view(np.uint32) for t in tab)


def _popcount(v: torch.Tensor) -> torch.Tensor:
    """Bits set in each int32 word (SWAR; each shift is masked, so the
    arithmetic shift of a negative word does no harm)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


def _pc_rows(words: torch.Tensor) -> torch.Tensor:
    """popcount summed over the word axis -> (..., rows) int64."""
    return _popcount(words).sum(-1)


def _bit(mat: torch.Tensor, q: int) -> torch.Tensor:
    """Bit q of every row: (..., rows, W) -> (..., rows) int32 0/1."""
    return (mat[..., q >> 5] >> (q & 31)) & 1


def _flip_col(mat: torch.Tensor, q: int, bits: torch.Tensor):
    """XOR per-row 0/1 ``bits`` into bit q of every row, in place."""
    col = mat[..., q >> 5]
    col ^= bits << (q & 31)


# -- gate application ---------------------------------------------------------

_DEV_TABLES: dict = {}


def _gate_table(u: np.ndarray, dev) -> torch.Tensor | None:
    """A prim's conjugation table on ``dev`` as one int32 entry per input
    pattern c: the k x bits to flip, the k z bits to flip (shifted by k)
    and the phase to add (shifted by 2k). None for a table that changes
    nothing (an identity prim: its step is skipped)."""
    u = np.asarray(u, dtype=np.complex128)
    key = (u.shape[0], u.tobytes(), str(dev))
    hit = _DEV_TABLES.get(key)
    if hit is None:
        tx, tz, ts = clifford_tables(u)
        k = u.shape[0].bit_length() - 1
        c = np.arange(4 ** k)
        xin = sum(((c >> (2 * j)) & 1) << j for j in range(k))
        zin = sum(((c >> (2 * j + 1)) & 1) << j for j in range(k))
        packed = ((tx ^ xin) | ((tz ^ zin) << k) | (ts << (2 * k))).astype(np.int32)
        hit = _DEV_TABLES[key] = torch.from_numpy(packed).to(dev) if packed.any() else False
    return hit if hit is not False else None


def _apply_table(x, z, s, targets, table):
    """One table-characterized prim on (..., rows, W) planes, in place on
    x and z; returns the new s (None for frames, which carry no phase)."""
    k = len(targets)
    idx = None
    for j, q in enumerate(targets):
        part = (_bit(x, q) << (2 * j)) | (_bit(z, q) << (2 * j + 1))
        idx = part if idx is None else idx | part
    g = table[idx.long()]
    for j, q in enumerate(targets):
        _flip_col(x, q, (g >> j) & 1)
        _flip_col(z, q, (g >> (k + j)) & 1)
    return None if s is None else (s + (g >> (2 * k))) & 3


def _apply_layer(x, z, s, prims, tables):
    """P prims on disjoint qubits, k targets each, as one step (in place on
    x and z; returns the new s). Disjoint prims commute and each reads only
    its own targets, so one gather of every target bit, one table lookup
    per (row, prim) and one scatter of the flips (distinct bits of the
    words: their sum is their XOR) give the sequential result."""
    k = len(prims[0].targets)
    dev = x.device
    tq = torch.tensor([p.targets for p in prims], dtype=torch.int64).to(dev)   # (P, k)
    w, off = tq >> 5, (tq & 31).to(torch.int32)
    sh = 2 * torch.arange(k, dtype=torch.int32, device=dev)
    idx = ((((x[..., w] >> off) & 1) << sh) | (((z[..., w] >> off) & 1) << (sh + 1))).sum(-1)
    g = torch.stack(tables)[torch.arange(len(prims), device=dev), idx]       # (..., rows, P)
    jj = torch.arange(k, dtype=torch.int32, device=dev)
    for plane, shift in ((x, jj), (z, jj + k)):
        flips = ((g[..., None] >> shift) & 1) << off                          # (..., rows, P, k)
        plane ^= torch.zeros_like(plane).index_add_(-1, w.flatten(), flips.flatten(-2))
    return (s + (g >> (2 * k)).sum(-1)) & 3


def _steps(prims, tables):
    """Group a prim chain into host steps: runs of 2 or more prims of one
    arity (at most 2) on disjoint qubits become one layer step; any other
    prim is a step of its own; identity prims take none."""
    steps, cur, used = [], [], set()

    def flush():
        if len(cur) > 1:
            steps.append(("layer", [p for p, _ in cur], [tb for _, tb in cur]))
        elif cur:
            steps.append(("one", cur[0][0], cur[0][1]))
        cur.clear()
        used.clear()

    for p, table in zip(prims, tables):
        if table is None:
            continue
        k = len(p.targets)
        if not cur or k > 2 or len(cur[0][0].targets) != k or used & set(p.targets):
            flush()
        cur.append((p, table))
        used.update(p.targets)
        if k > 2:
            flush()
    flush()
    return steps


def apply_prims(tab: Tableau, prims) -> Tableau:
    """Apply a sequence of Clifford :class:`~qubism_torch.core.gates.Prim`s
    (any arity) to a copy of ``tab``: one host step per prim, or per layer
    of prims on disjoint qubits (:func:`_steps`). Non-Clifford prims raise
    :class:`NotCliffordError` before anything is changed."""
    prims = tuple(prims)
    if not prims:
        return tab
    dev = tab.x.device
    tables = [_gate_table(p.dense(), dev) for p in prims]
    x, z, s = tab.x.clone(), tab.z.clone(), tab.s
    for kind, ps, tb in _steps(prims, tables):
        if kind == "one":
            s = _apply_table(x, z, s, ps.targets, tb)
        else:
            s = _apply_layer(x, z, s, ps, tb)
    return Tableau(x, z, s.to(torch.int32))


def pauli_phase(tab: Tableau, q: int, c: torch.Tensor) -> torch.Tensor:
    """The phase after Pauli ``c`` (0 I, 1 X, 2 Y, 3 Z; an int per tableau)
    on qubit q: rows that anticommute with it change sign."""
    c = c[..., None]
    cx = (c ^ (c >> 1)) & 1
    cz = (c >> 1) & 1
    b = (cx & _bit(tab.z, q)) ^ (cz & _bit(tab.x, q))
    return (tab.s + 2 * b) & 3


# -- the deterministic fold -----------------------------------------------------

#: past this qubit count the mod-4 phase accumulators of the batched
#: deterministic readout (bounded by 3n^2) no longer fit float32 exactly;
#: past it a register is read qubit by qubit (the prefix fold, in integers)
_DET_BATCH_MAX_N = 2048


def _unpack(words: torch.Tensor, n: int) -> torch.Tensor:
    """(..., rows, W) int32 -> (..., rows, n) float32 bit matrix."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.flatten(-2)[..., :n].to(torch.float32)


def _prefix_xor(a: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix XOR along the row axis (-2) in log2(rows)
    doubling steps: row i of the result is a[0] ^ ... ^ a[i-1]."""
    rows = a.shape[-2]
    d = 1
    while d < rows:
        a = torch.cat([a[..., :d, :], a[..., d:, :] ^ a[..., :-d, :]], dim=-2)
        d *= 2
    return torch.cat([torch.zeros_like(a[..., :1, :]), a[..., :-1, :]], dim=-2)


def _fold_phase(sel: torch.Tensor, xs, zs, ss, n: int) -> torch.Tensor:
    """Phase mod 4 of the product of the stabilizer rows selected by each
    0/1 row of ``sel`` ((..., k, n) int32), folded in row order as the JAX
    package's ``fori_loop`` does: ``s += s_i + 2 popcount(z_run & x_i)``.
    The cross terms are linear mod 4, so the fold is
    ``sel.s + 2 sel.triu(C,1).sel`` with ``C[j,i] = popcount(z_j & x_i)``:
    three float32 matmuls for several selections (n <= _DET_BATCH_MAX_N);
    for one selection, or past the guard, the prefix form in integers."""
    if sel.shape[-2] > 1 and n <= _DET_BATCH_MAX_N:
        zb, xb = _unpack(zs, n), _unpack(xs, n)
        c = zb @ xb.transpose(-1, -2)
        cut = torch.triu(c.to(torch.int32) & 3, 1).to(torch.float32)
        self_ = sel.to(torch.float32)
        lin = (self_ @ ss.to(torch.float32)[..., None])[..., 0]
        quad = ((self_ @ cut) * self_).sum(-1)
        return (lin.to(torch.int64) + 2 * quad.to(torch.int64)) & 3
    # (..., k, n, W): the selected z rows, their running XOR before row i
    zsel = (-sel)[..., None] & zs[..., None, :, :]
    cross = _pc_rows(_prefix_xor(zsel) & xs[..., None, :, :]) & 1
    return (sel * (ss[..., None, :] + 2 * cross)).sum(-1) & 3


def _sel_cols(x: torch.Tensor, qs, n: int, rows: slice) -> torch.Tensor:
    """x bits at each qubit of ``qs`` for the given rows: (..., rows, k)."""
    q = torch.as_tensor(np.asarray(qs, dtype=np.int64), device=x.device)
    return (x[..., rows, :][..., q >> 5] >> (q & 31).to(torch.int32)) & 1


def det_outcomes(tab: Tableau, qs, n: int):
    """Batched DETERMINISTIC Z-measurement of every qubit in ``qs``:
    ``(any_random, outcomes)``, the flag (a bool per tableau) set when a
    listed qubit is random, in which case the outcomes are meaningless.
    The tableau is unchanged either way (as in the JAX package's
    ``_det_outcomes_impl``)."""
    x, z, s = tab
    cols = _sel_cols(x, qs, n, slice(None))              # (..., 2n, k)
    any_random = (cols[..., n:, :] == 1).flatten(-2).any(-1)
    sel = cols[..., :n, :].transpose(-1, -2)            # (..., k, n)
    phase = _fold_phase(sel, x[..., n:, :], z[..., n:, :], s[..., n:], n)
    return any_random, ((phase >> 1) & 1).to(torch.int32)


def x_phase_flips(tab: Tableau, qs, flips: torch.Tensor) -> torch.Tensor:
    """The phase after ``X_q`` for every qubit q of ``qs`` whose ``flips``
    bit is set, in one pass: ``s += 2 sum_q flips_q zbit(row, q) mod 4``."""
    n = tab.x.shape[-2] // 2
    zb = _sel_cols(tab.z, qs, n, slice(None))            # (..., 2n, k)
    tot = (zb * flips[..., None, :].to(torch.int32)).sum(-1)
    return ((tab.s + 2 * (tot & 1)) & 3).to(torch.int32)


# -- measurement --------------------------------------------------------------


def _random_branch(tab: Tableau, q: int, p: torch.Tensor, outcome, n: int) -> Tableau:
    """The measurement update of qubit q with stabilizer pivot row ``p``
    (an int64 per tableau) and the given outcome (an int per tableau, or
    a scalar): every other row with an x bit at q absorbs row p, the old
    row p becomes destabilizer p - n, row p becomes (-1)^outcome Z_q."""
    x, z, s = tab
    rows, w = x.shape[-2], x.shape[-1]
    xq = _bit(x, q)
    ar = torch.arange(rows, device=x.device)
    mask = xq * (ar != p[..., None]).to(torch.int32)
    pr = p[..., None, None].expand(*x.shape[:-2], 1, w)
    xp = torch.take_along_dim(x, pr, dim=-2)               # (..., 1, W)
    zp = torch.take_along_dim(z, pr, dim=-2)
    sp = torch.take_along_dim(s, p[..., None], dim=-1)     # (..., 1)
    cross = 2 * _pc_rows(z & xp)
    s2 = ((s + mask * (sp + cross)) & 3).to(torch.int32)
    m = (-mask)[..., None]
    x2 = x ^ (m & xp)
    z2 = z ^ (m & zp)
    x2 = x2.scatter(-2, pr - n, xp)
    z2 = z2.scatter(-2, pr - n, zp)
    s2 = s2.scatter(-1, p[..., None] - n, sp)
    zq = torch.zeros(w, dtype=torch.int32, device=x.device)
    zq[q >> 5] = _bitval(q & 31)
    x2 = x2.scatter(-2, pr, torch.zeros_like(xp))
    z2 = z2.scatter(-2, pr, zq.expand_as(zp).contiguous())
    out = torch.as_tensor(outcome, device=x.device).to(torch.int32)
    s2 = s2.scatter(-1, p[..., None], (2 * out).reshape(*out.shape, 1).expand_as(sp).contiguous())
    return Tableau(x2, z2, s2)


def _where(cond: torch.Tensor, a: Tableau, b: Tableau) -> Tableau:
    """Per tableau of a batch: ``a`` where ``cond``, else ``b``."""
    return Tableau(torch.where(cond[:, None, None], a.x, b.x),
                   torch.where(cond[:, None, None], a.z, b.z),
                   torch.where(cond[:, None], a.s, b.s))


def measure_seq(tab: Tableau, qs, rnd_bits: torch.Tensor, n: int):
    """Measure the qubits ``qs`` in order in the Z basis: the outcomes and
    the tableau of the JAX package's ``_measure_seq_impl`` (``rnd_bits[...,
    i]``, an int per tableau, is the outcome of qubit i when it is random,
    and is consumed only then). Returns ((..., k) int32 outcomes, tableau).

    The deterministic branch leaves the tableau unchanged, so the register
    is read in rounds: find the first qubit still left that is random (in
    any tableau of a batch; one host read), read every qubit before it by
    one :func:`det_outcomes` batch, take the random branch for it (per
    tableau of a batch, ``torch.where`` against its deterministic outcome),
    repeat. Past ``_DET_BATCH_MAX_N`` every qubit is a round of its own."""
    qs = [int(q) for q in qs]
    batched = tab.x.dim() == 3
    outs = []
    i = 0
    while i < len(qs):
        stats["rounds"] += 1
        rest = qs[i:]
        if n <= _DET_BATCH_MAX_N:
            stab = _sel_cols(tab.x, rest, n, slice(n, None)) == 1   # (..., n, k)
            anyr = stab.flatten(0, -2).any(0) if batched else stab.any(0)
            r = _host(torch.cat([anyr, anyr.new_ones(1)]).to(torch.int8).argmax())
            if r:
                outs.append(det_outcomes(tab, rest[:r], n)[1])
            if r == len(rest):
                break
        else:
            r = 0
        q = rest[r]
        xq = _bit(tab.x[..., n:, :], q)
        rand = xq.any(-1)
        p = n + xq.to(torch.int8).argmax(-1)
        rb = rnd_bits[..., i + r].to(torch.int32)
        if not batched and (n <= _DET_BATCH_MAX_N or _host(rand)):
            tab = _random_branch(tab, q, p, rb, n)
            outs.append(rb.reshape(1))
        elif not batched:
            outs.append(det_outcomes(tab, [q], n)[1])
        else:
            det = det_outcomes(tab, [q], n)[1][:, 0]
            tab = _where(rand, _random_branch(tab, q, p, rb, n), tab)
            outs.append(torch.where(rand, rb, det)[:, None])
        i += r + 1
    if not outs:
        shape = tab.s.shape[:-1] + (0,)
        return torch.zeros(shape, dtype=torch.int32, device=tab.x.device), tab
    return torch.cat(outs, dim=-1), tab


def measure_qubit(tab: Tableau, q: int, gen: torch.Generator, n: int):
    """Measure qubit ``q`` of one tableau in the Z basis; returns (outcome
    int, tableau, gen). A random outcome is a fair bit drawn from the CPU
    generator ``gen``, which advances; the JAX package's counterpart takes
    and returns a key."""
    rnd = torch.randint(0, 2, (1,), generator=gen, dtype=torch.int32).to(tab.x.device)
    outs, tab = measure_seq(tab, [q], rnd, n)
    return int(_host(outs)[0]), tab, gen


# -- shot sampling --------------------------------------------------------------


def _np_popcount(v: np.ndarray) -> np.ndarray:
    """Bits set in each uint32 (SWAR: ``np.bitwise_count`` needs numpy 2)."""
    v = v.astype(np.uint32)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * np.uint32(0x01010101)) >> 24).astype(np.uint64)


def _unpack_bits(words: np.ndarray, n: int) -> np.ndarray:
    """(rows, W) uint32 -> (rows, n) uint8 (bit q of the row = column q)."""
    rows = words.shape[0]
    if rows == 0:
        return np.zeros((0, n), dtype=np.uint8)
    b = np.ascontiguousarray(words, dtype="<u4").view(np.uint8).reshape(rows, -1)
    return np.unpackbits(b, axis=1, bitorder="little")[:, :n]


def affine_support(tab: Tableau, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The Z-basis distribution of a stabilizer state is uniform over an
    affine subspace ``{x0 XOR r.V : r in GF(2)^R}``: ``(x0, V)`` (x0 an (n,)
    uint8 row, V an (R, n) uint8 basis) by one GF(2) Gaussian elimination
    on the host, as the JAX package's ``affine_support``: rows keeping an
    X pivot span V; rows eliminated to pure Z^z with phase i^s constrain
    ``z.x = s/2 (mod 2)``, solved for one point x0."""
    xa, za, sa = planes_from_tableau(tab)
    x = xa[n:].copy()
    z = za[n:].copy()
    s = sa[n:].astype(np.uint64)
    rows = n

    def mul_into(j_mask, p):
        """Rows selected by boolean j_mask absorb row p (group product)."""
        cross = np.zeros(rows, dtype=np.uint64)
        xp = x[p]
        for w in range(x.shape[1]):
            cross += _np_popcount(z[:, w] & xp[w])
        s[j_mask] = (s[j_mask] + s[p] + 2 * cross[j_mask]) & 3
        x[j_mask] ^= x[p]
        z[j_mask] ^= z[p]

    pivots = []
    used = np.zeros(rows, dtype=bool)
    for q in range(n):
        w, off = q >> 5, np.uint32(q & 31)
        col = (x[:, w] >> off) & 1
        cand = np.nonzero(col.astype(bool) & ~used)[0]
        if cand.size == 0:
            continue
        p = int(cand[0])
        used[p] = True
        pivots.append((p, q))
        others = col.astype(bool).copy()
        others[p] = False
        if others.any():
            mul_into(others, p)

    V = (_unpack_bits(x[[p for p, _ in pivots]], n)
         if pivots else np.zeros((0, n), dtype=np.uint8))
    zrows = np.nonzero(~used)[0]
    zb = _unpack_bits(z[zrows], n)
    assert not (s[zrows] & 1).any(), "non-Hermitian pure-Z stabilizer row"
    rhs = ((s[zrows] >> 1) & 1).astype(np.uint8)
    x0 = np.zeros(n, dtype=np.uint8)
    r = 0
    for q in range(n):
        hit = np.nonzero(zb[r:, q] == 1)[0]
        if hit.size == 0:
            continue
        p = r + int(hit[0])
        zb[[r, p]] = zb[[p, r]]
        rhs[[r, p]] = rhs[[p, r]]
        elim = (zb[:, q] == 1)
        elim[r] = False
        zb[elim] ^= zb[r]
        rhs[elim] ^= rhs[r]
        r += 1
    # Gauss-Jordan leaves each pivot column with a single 1; with the free
    # variables fixed to 0 the pivot variables read straight off rhs
    for i in range(r):
        x0[int(np.argmax(zb[i] == 1))] = rhs[i]
    return x0, V


def affine_sample(x0: torch.Tensor, v: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``x0 XOR r.V`` for every row of the 0/1 matrix ``r`` ((shots, R)):
    one float32 matmul mod 2 (exact: 0/1 operands, sums <= R < 2^24).
    Returns (shots, n) uint8 on the device."""
    prod = r.to(torch.float32) @ v.to(torch.float32)
    return ((prod.to(torch.int32) & 1) ^ x0.to(torch.int32)).to(torch.uint8)


def sample_bits(tab: Tableau, shots: int, n: int, gen: torch.Generator | None = None,
                support=None) -> np.ndarray:
    """``shots`` independent full-register measurements, non-destructive:
    (shots, n) uint8, column j = qubit j. One host elimination
    characterizes the distribution (``support`` gives it precomputed); the
    shots are one (shots, R) x (R, n) matmul on the device, their R random
    bits each drawn there from ``gen`` (a generator on the tableau's
    device)."""
    x0, v = affine_support(tab, n) if support is None else support
    if v.shape[0] == 0:
        return np.broadcast_to(x0, (shots, n)).copy()
    dev = tab.x.device
    r = torch.randint(0, 2, (shots, v.shape[0]), generator=gen, device=dev,
                      dtype=torch.int32)
    bits = affine_sample(torch.from_numpy(x0).to(dev), torch.from_numpy(v).to(dev), r)
    stats["syncs"] += 1
    return bits.cpu().numpy()


# -- Pauli-string expectation -------------------------------------------------


def _pack_pauli(pauli: str) -> tuple[np.ndarray, np.ndarray]:
    px = np.zeros(_words(len(pauli)), dtype=np.uint32)
    pz = np.zeros_like(px)
    for q, ch in enumerate(pauli.upper()):
        if ch in "XY":
            px[q >> 5] |= np.uint32(1 << (q & 31))
        if ch in "ZY":
            pz[q >> 5] |= np.uint32(1 << (q & 31))
        if ch not in "IXYZ":
            raise ValueError(f"bad Pauli character {ch!r}")
    return px, pz


def expect_packed(tab: Tableau, pauli: str, n: int) -> torch.Tensor:
    """<P> per tableau (a float32 tensor of the batch's shape): 0 when P
    anticommutes with a stabilizer, else the sign with which the product
    of the stabilizers selected by the destabilizers anticommuting with P
    equals P (the fold of :func:`_fold_phase`; no loop over rows)."""
    x, z, s = tab
    pxn, pzn = _pack_pauli(pauli)
    dev = x.device
    px = torch.from_numpy(pxn.view(np.int32).copy()).to(dev)
    pz = torch.from_numpy(pzn.view(np.int32).copy()).to(dev)
    anti = (_pc_rows(x[..., n:, :] & pz) + _pc_rows(z[..., n:, :] & px)) & 1
    undetermined = anti.any(-1)
    sel = ((_pc_rows(x[..., :n, :] & pz) + _pc_rows(z[..., :n, :] & px)) & 1).to(torch.int32)
    xs, zs, ss = x[..., n:, :], z[..., n:, :], s[..., n:]
    qs = _fold_phase(sel[..., None, :], xs, zs, ss, n)[..., 0]
    self_ = sel.to(torch.float32)[..., None, :]
    qx = (self_ @ _unpack(xs, n))[..., 0, :].to(torch.int32) & 1
    qz = (self_ @ _unpack(zs, n))[..., 0, :].to(torch.int32) & 1
    want_x = torch.from_numpy(_unpack_bits(pxn[None], n)[0]).to(dev)
    want_z = torch.from_numpy(_unpack_bits(pzn[None], n)[0]).to(dev)
    matches = ((qx == want_x) & (qz == want_z)).all(-1)
    herm = int(_np_popcount(pxn & pzn).sum())
    sign = ((qs - herm) & 3) >> 1
    val = 1.0 - 2.0 * sign.to(torch.float32)
    return torch.where(undetermined | ~matches, torch.zeros_like(val), val)


def expectation(tab: Tableau, pauli: str, n: int) -> float:
    """<P> for a Pauli string (index 0 = qubit 0): -1, 0 or +1."""
    if len(pauli) != n:
        raise ValueError(f"Pauli string length {len(pauli)} != n={n}")
    return float(_host(expect_packed(tab, pauli, n)))


# -- inspection ---------------------------------------------------------------


def stabilizer_strings(tab: Tableau, n: int, destabilizers: bool = False):
    """Decode rows to text like ``+XXI`` / ``-IZZ`` (for ``:dump``)."""
    x, z, s = planes_from_tableau(tab)
    lo, hi = (0, n) if destabilizers else (n, 2 * n)
    out = []
    for r in range(lo, hi):
        chars = []
        herm = 0
        for q in range(n):
            xb = int((x[r, q >> 5] >> (q & 31)) & 1)
            zb = int((z[r, q >> 5] >> (q & 31)) & 1)
            herm += xb & zb
            chars.append("IXZY"[xb + 2 * zb])
        sign = "-" if ((int(s[r]) - herm) >> 1) & 1 else "+"
        out.append(sign + "".join(chars))
    return out


# -- the user-facing simulator ------------------------------------------------


class StabilizerSim:
    """Stateful Clifford simulator mirroring the Session/StateVec surface:
    ``apply`` (Gate or prim stream), ``measure_qubit(s)``, ``reset``,
    ``sample``, ``expectation``, ``stabilizers``. Random bits come from a
    CPU generator seeded with ``seed`` (or ``gen``); shots draw theirs on
    the device from a generator seeded by it."""

    def __init__(self, n: int, seed: int | None = None, gen: torch.Generator | None = None):
        self.n = n
        self.tab = identity_tableau(n)
        self.gen = gen if gen is not None else torch.Generator().manual_seed(
            0 if seed is None else seed)
        self._support = None        # cached affine_support, dropped on mutation

    def apply(self, gate_or_prims) -> "StabilizerSim":
        prims = getattr(gate_or_prims, "prims", gate_or_prims)
        self.tab = apply_prims(self.tab, prims)
        self._support = None
        return self

    def _bits(self, k: int) -> torch.Tensor:
        return torch.randint(0, 2, (k,), generator=self.gen, dtype=torch.int32).to(self.tab.x.device)

    def measure_qubit(self, q: int) -> int:
        return self.measure_qubits([q])[0]

    def measure_qubits(self, qubits) -> list[int]:
        qubits = list(qubits)
        outs, self.tab = measure_seq(self.tab, qubits, self._bits(len(qubits)), self.n)
        self._support = None
        return [int(b) for b in _host(outs)]

    def reset(self, q: int) -> None:
        """Project qubit q to |0>: measure with a FORCED 0 outcome (on a
        random outcome that IS the projection); a |1>-certain qubit, whose
        projection is the zero vector, takes the X flip instead (the
        physical reset), as the JAX package does."""
        zero = torch.zeros(1, dtype=torch.int32, device=self.tab.x.device)
        out, self.tab = measure_seq(self.tab, [q], zero, self.n)
        self._support = None
        if _host(out)[0]:
            from ..core.gates import Prim

            self.apply((Prim(_X2, (q,)),))

    def sample(self, shots: int, gen: torch.Generator | None = None) -> np.ndarray:
        if gen is None:
            seed = int(torch.randint(0, 2**62, (1,), generator=self.gen))
            gen = torch.Generator(device=self.tab.x.device).manual_seed(seed)
        if self._support is None:
            self._support = affine_support(self.tab, self.n)
        return sample_bits(self.tab, shots, self.n, gen, support=self._support)

    def expectation(self, pauli: str) -> float:
        return expectation(self.tab, pauli, self.n)

    def stabilizers(self) -> list[str]:
        return stabilizer_strings(self.tab, self.n)
