"""Pauli-frame executors for noisy Clifford sampling (Stim-style).

Counterpart of qubism_tpu/stabilizer/frames.py. A Clifford circuit whose
only observation is a final measurement needs no tableau per trajectory:
each trajectory's accumulated error is one Pauli frame, conjugated through
the rest of the circuit by the same table step that evolves tableau rows,
and it flips the clean outcomes where it has an X component (Gidney's Stim,
arXiv:2103.02202). The frames of all trajectories are one (T, W) word
matrix per plane with no phase; the clean outcomes are one affine GF(2)
sample (tableau.py:sample_bits).

Mid-circuit **measurement and reset** also run on frames (Stim's frame
simulator, arXiv:2103.02202 §4): a measure row reads the frame's X bit
(outcome = clean outcome XOR it) and XORs a fresh random bit into Z; a
reset row clears X and randomizes Z; frames start with random Z. The
clean record comes from ONE exact tableau pass (:func:`_clean_record`).
Frame reset is the physical measure-discard-reprepare reset; the exact
engines project to |0>; they agree when the reset qubit was just measured
or holds a definite value, and noise.py sends other programs to the
tableau batch.

Layered executor: with phases dropped a Clifford's frame action is
GF(2)-linear in (x0, z0, x1, z1), a 4x4 bit matrix per prim
(:func:`_gf2_mbits`); disjoint-qubit prims pack into layers
(:func:`_build_layers`), frames are stored shot-major (row q = qubit q's
bits across trajectories, 32 trajectories a word), and a layer is a
handful of word-wide gather / AND / XOR / scatter ops.

Every scan of the JAX package here walks its host tape in Python: a step's
qubits and op code are host ints, so it launches only that step's own ops.
Uniforms are drawn on the tableau's device, in blocks, from a generator
there seeded with ``seed``; a measured frame record comes back to the host
once, at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.apply import device
from .tableau import (_DET_BATCH_MAX_N, _ID4, _apply_table, _bit, _flip_col,
                      _gate_table, _host, _pack_pauli, _pc_rows, affine_support,
                      apply_prims, clifford_tables, det_outcomes, expectation,
                      identity_tableau, measure_seq, sample_bits, stats,
                      x_phase_flips)

__all__ = ["frame_run_vals", "frame_run_vals_events", "frame_expectation",
           "frame_expectation_sum", "frame_expectations"]


def _gen(seed, dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(0 if seed is None else int(seed))


class _Uniforms:
    """(k, T) float32 uniforms on the device on request, drawn in blocks
    of at most 2^26 values (one launch per block)."""

    def __init__(self, gen, ntraj, total, dev):
        self.gen, self.t, self.left, self.dev = gen, ntraj, total, dev
        self.buf, self.at = None, 0

    def take(self, k: int) -> torch.Tensor:
        if self.buf is None or self.at + k > self.buf.shape[0]:
            rows = max(k, min(self.left, max(1, (1 << 26) // self.t)))
            self.buf = torch.rand((rows, self.t), generator=self.gen, device=self.dev)
            self.at = 0
        out = self.buf[self.at:self.at + k]
        self.at += k
        self.left -= k
        return out


def _pauli_index(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Pauli index per uniform: the number of the channel's cumulative
    probabilities (all but the last) that are <= u (0 I, 1 X, 2 Y, 3 Z; for
    a 2q channel 0..15, ``c >> 2`` on the first qubit, ``c & 3`` on the
    second)."""
    return (cdf[:-1, None] <= u[None, :]).sum(0).to(torch.int32)


def _inject(fx, fz, q: int, c: torch.Tensor):
    """XOR Pauli ``c`` (one per frame row) into the frames at qubit q."""
    _flip_col(fx, q, (c ^ (c >> 1)) & 1)   # X, Y
    _flip_col(fz, q, (c >> 1) & 1)         # Y, Z


def _cdfs(prog, dev):
    c1 = np.asarray(prog.cdfs, np.float32).reshape(-1, 4)
    c2 = np.asarray(getattr(prog, "cdfs2", np.zeros((0, 16), np.float32)),
                    np.float32).reshape(-1, 16)
    return torch.from_numpy(c1).to(dev), torch.from_numpy(c2).to(dev)


def _propagate(prog, prims, ntraj: int, gen, dev):
    """The noisy frame scan over a chain of 1- and 2-qubit prims: (T, W)
    fx/fz planes after it. After each prim, every 1q channel draws a Pauli
    on each of its qubits, every 2q channel one joint Pauli on a 2q prim."""
    words = (prog.n + 31) // 32
    fx = torch.zeros((ntraj, words), dtype=torch.int32, device=dev)
    fz = torch.zeros_like(fx)
    cdfs, cdfs2 = _cdfs(prog, dev)
    c1, c2 = cdfs.shape[0], cdfs2.shape[0]
    total = sum(c1 * len(p.targets) + c2 * (len(p.targets) == 2) for p in prims)
    us = _Uniforms(gen, ntraj, total, dev)
    for p in prims:
        t = p.targets
        table = _gate_table(p.dense(), dev)
        if table is not None:
            _apply_table(fx, fz, None, t, table)
        if c1:
            u = us.take(c1 * len(t))
            for ci in range(c1):
                for j, q in enumerate(t):
                    _inject(fx, fz, q, _pauli_index(cdfs[ci], u[ci * len(t) + j]))
        if c2 and len(t) == 2:
            u = us.take(c2)
            for ci in range(c2):
                c = _pauli_index(cdfs2[ci], u[ci])
                _inject(fx, fz, t[0], c >> 2)
                _inject(fx, fz, t[1], c & 3)
    return fx, fz


def _packable(prims) -> bool:
    return all(len(p.targets) <= 2 for p in prims)


def _clean_tableau(n, prims, dev):
    return apply_prims(identity_tableau(n, dev), prims)


def _frame_signs(fx, fz, pauli: str) -> np.ndarray:
    """(T,) float64 +1/-1: whether each frame commutes with the Pauli."""
    px, pz = (torch.from_numpy(a.view(np.int32).copy()).to(fx.device)
              for a in _pack_pauli(pauli))
    anti = (_pc_rows(fx & pz) + _pc_rows(fz & px)) & 1
    stats["syncs"] += 1
    return 1.0 - 2.0 * anti.cpu().numpy().astype(np.float64)


def frame_expectations(prog, prims, paulis, ntraj: int, seed=None):
    """Per-Pauli (mean, stderr) for MANY strings from ONE frame
    propagation: each string's per-trajectory sign is a popcount parity
    against the same planes, times its exact clean value. None when a prim
    has more than two targets."""
    if not _packable(prims):
        return None
    n, dev = prog.n, device()
    tab = _clean_tableau(n, prims, dev)
    cleans = [expectation(tab, p, n) for p in paulis]
    if all(c == 0.0 for c in cleans):
        # <P> of F|psi> is +-<P> of |psi> for any Pauli frame F: still 0
        return [(0.0, 0.0)] * len(paulis)
    fx, fz = _propagate(prog, prims, ntraj, _gen(seed, dev), dev)
    out = []
    for pauli, clean in zip(paulis, cleans):
        if clean == 0.0:
            out.append((0.0, 0.0))
            continue
        signs = clean * _frame_signs(fx, fz, pauli)
        se = float(signs.std(ddof=1) / np.sqrt(ntraj)) if ntraj > 1 else 0.0
        out.append((float(signs.mean()), se))
    return out


def frame_expectation(prog, prims, pauli: str, ntraj: int, seed=None):
    """Monte-Carlo ``<P>``: the one-term case of
    :func:`frame_expectation_sum`."""
    return frame_expectation_sum(prog, prims, ((1.0, pauli),), ntraj, seed)


def frame_expectation_sum(prog, prims, terms, ntraj: int, seed=None):
    """Monte-Carlo ``<H>`` for ``terms = [(coef, pauli), ...]`` from ONE
    frame propagation; the per-trajectory energy is summed first, so the
    stderr includes the terms' correlations. None when unpackable."""
    if not _packable(prims):
        return None
    n, dev = prog.n, device()
    tab = _clean_tableau(n, prims, dev)
    cleans = [expectation(tab, pauli, n) for _, pauli in terms]
    if all(c == 0.0 for c in cleans):
        return 0.0, 0.0
    fx, fz = _propagate(prog, prims, ntraj, _gen(seed, dev), dev)
    energies = np.zeros(ntraj, dtype=np.float64)
    for (coef, pauli), clean in zip(terms, cleans):
        if clean != 0.0:
            energies += coef * clean * _frame_signs(fx, fz, pauli)
    mean = float(energies.mean())
    stderr = float(energies.std(ddof=1) / np.sqrt(ntraj)) if ntraj > 1 else 0.0
    return mean, stderr


def _frame_bits(fx, n: int) -> torch.Tensor:
    """(T, W) frame words -> (T, n) uint8 bits of qubits 0..n-1."""
    shifts = torch.arange(32, dtype=torch.int32, device=fx.device)
    return ((fx[..., None] >> shifts) & 1).flatten(-2)[:, :n].to(torch.uint8)


def _readout_flips(prog, gen, ntraj, k, dev):
    """(T, k) uint8 reporting flips of the readout channel, or None."""
    p = getattr(prog, "readout_p", None)
    if not p:
        return None
    u = torch.rand((ntraj, k), generator=gen, device=dev)
    stats["syncs"] += 1
    return (u < np.float32(p).item()).to(torch.uint8).cpu().numpy()


def _write_vals(vals, writes, cols, ro):
    """Store one measure event's (T,) outcome columns in the creg arrays;
    readout flips are per WRITE (a qubit measured by two merged statements
    gets two independent reporting flips)."""
    off = 0
    for creg, bit_index, count in writes:
        for k_ in range(count):
            col = cols[off + k_]
            if ro is not None:
                col = col ^ ro[:, off + k_]
            if bit_index is None:
                vals[creg][:, k_] = col
            else:
                vals[creg][:, bit_index] = col
        off += count


def frame_run_vals(prog, prims, measure_event, ntraj: int, seed=None):
    """``ntraj`` noisy trajectories of (Clifford prims -> final measurement)
    by Pauli frames: the creg-name -> (ntraj, size) int32 dict of
    ``run_vals``, or None when a prim has more than two targets."""
    if not _packable(prims):
        return None
    n, dev = prog.n, device()
    gen = _gen(seed, dev)
    tab = _clean_tableau(n, prims, dev)
    clean = sample_bits(tab, ntraj, n, gen, support=affine_support(tab, n))
    fx, _ = _propagate(prog, prims, ntraj, gen, dev)
    stats["syncs"] += 1
    bits = clean ^ _frame_bits(fx, n).cpu().numpy()
    ro = _readout_flips(prog, gen, ntraj, len(measure_event.qubits), dev)
    vals = {c: np.zeros((ntraj, prog.creg_sizes[c]), dtype=np.int32)
            for c in prog.creg_names}
    _write_vals(vals, measure_event.writes, [bits[:, q] for q in measure_event.qubits], ro)
    return vals


# ---------------------------------------------------------------------------
# Mid-circuit measurement / reset on frames
# ---------------------------------------------------------------------------

#: tape opcodes: gate row / measure row / reset row / padding / QUIET gate
#: row (statically noise-free: no uniforms drawn)
_FOP_GATE, _FOP_MEASURE, _FOP_RESET, _FOP_NOP, _FOP_GATEQ = 0, 1, 2, 3, 4


def _pack_frame_tape(events, n: int, identity_noise_only: bool = False):
    """Walk EvGates/EvMeasure/EvReset events into ONE interleaved tape:
    gate rows carry 2-qubit Clifford tables (a 1q prim promoted with an
    identity partner), each measured/reset qubit gets its own row. Returns
    ``(codes, t0, t1, txs, tzs, flags, flags2, meas_rows)`` (numpy, padded
    to the next power of two with NOPs, as the JAX package's) or None when a
    gate has arity > 2. ``identity_noise_only`` restricts noise to 1q
    IDENTITY rows (the phenomenological model of models/qec.py)."""
    from ..run.compiler import EvDump, EvGates, EvMeasure, EvReset

    codes, t0s, t1s, txs, tzs = [], [], [], [], []
    fl1, fl2 = [], []
    meas_rows: list[int] = []
    itx, itz, _ = clifford_tables(_ID4)
    ident2 = np.eye(2, dtype=np.complex128)

    def row(code, q0, q1, tx, tz, f1, f2):
        codes.append(code)
        t0s.append(q0)
        t1s.append(q1)
        txs.append(tx)
        tzs.append(tz)
        fl1.append(f1)
        fl2.append(f2)

    for ev in events:
        if isinstance(ev, EvGates):
            for p in ev.prims:
                targets = p.targets
                if len(targets) == 1:
                    q = targets[0]
                    u2 = np.kron(np.eye(2, dtype=np.complex128), p.dense())
                    tx, tz, _ = clifford_tables(u2)
                    noisy = not identity_noise_only or np.allclose(p.dense(), ident2)
                    row(_FOP_GATE if noisy else _FOP_GATEQ,
                        (q + 1) % n, q, tx, tz, (0, 1 if noisy else 0), 0)
                elif len(targets) == 2:
                    tx, tz, _ = clifford_tables(p.dense())
                    f = 0 if identity_noise_only else 1
                    row(_FOP_GATE if f else _FOP_GATEQ,
                        targets[0], targets[1], tx, tz, (f, f), f)
                else:
                    return None
        elif isinstance(ev, EvMeasure):
            for q in ev.qubits:
                meas_rows.append(len(codes))
                row(_FOP_MEASURE, q, q, itx, itz, (0, 0), 0)
        elif isinstance(ev, EvReset):
            for q in ev.qubits:
                row(_FOP_RESET, q, q, itx, itz, (0, 0), 0)
        elif isinstance(ev, EvDump):
            continue
        else:  # pragma: no cover - eligibility is checked by the caller
            return None
    if not codes:
        return None
    g = 1 << (len(codes) - 1).bit_length()
    while len(codes) < g:
        row(_FOP_NOP, 0, 1, itx, itz, (0, 0), 0)
    return (np.asarray(codes, np.int32),
            np.asarray(t0s, np.uint32), np.asarray(t1s, np.uint32),
            np.stack(txs), np.stack(tzs),
            np.asarray(fl1, np.uint32), np.asarray(fl2, np.uint32),
            meas_rows)


def _clean_record(n: int, events, gen: torch.Generator, dev):
    """ONE exact tableau pass over the event stream: the clean reference
    outcomes (a uint8 array per measure event), in program order. Reset
    follows the reference's projection (forced-0 measurement, X flip on a
    |1>-certain qubit). An event whose qubits are all deterministic (the
    QEC workload) is read by one :func:`det_outcomes` batch with no
    tableau change, its reset flips in one pass; one host read per event.
    ``gen`` (a CPU generator) draws the outcomes of random qubits."""
    from ..run.compiler import EvDump, EvGates, EvMeasure, EvReset

    tab = identity_tableau(n, dev)
    rec: list[np.ndarray] = []
    for ev in events:
        if isinstance(ev, EvGates):
            tab = apply_prims(tab, ev.prims)
        elif isinstance(ev, (EvMeasure, EvReset)):
            qs = list(ev.qubits)
            outs = None
            if n <= _DET_BATCH_MAX_N:
                anyr, o = det_outcomes(tab, qs, n)
                got = _host(torch.cat([anyr.reshape(1).to(torch.int32), o]))
                if not got[0]:
                    outs = o
            if outs is None:
                if isinstance(ev, EvMeasure):
                    rnd = torch.randint(0, 2, (len(qs),), generator=gen, dtype=torch.int32)
                else:
                    rnd = torch.zeros(len(qs), dtype=torch.int32)
                outs, tab = measure_seq(tab, qs, rnd.to(dev), n)
                got = [0] + _host(outs)
            if isinstance(ev, EvMeasure):
                rec.append(np.asarray(got[1:], dtype=np.uint8))
            else:
                tab = tab._replace(s=x_phase_flips(tab, qs, outs))
        elif isinstance(ev, EvDump):
            continue
    return rec


def _events_vals(prog, events, ntraj, clean, flips, gen, dev):
    """The creg arrays of a mid-circuit frame run: per measure event, the
    clean outcomes XOR the frame's flips (``flips``: one (T,) uint8 array
    per measured qubit, in program order), then the readout flips."""
    from ..run.compiler import EvMeasure

    vals = {c: np.zeros((ntraj, prog.creg_sizes[c]), dtype=np.int32)
            for c in prog.creg_names}
    mi = ri = 0
    for ev in events:
        if not isinstance(ev, EvMeasure):
            continue
        cols = [clean[mi][k_] ^ flips[ri + k_] for k_ in range(len(ev.qubits))]
        mi += 1
        ri += len(ev.qubits)
        _write_vals(vals, ev.writes, cols, _readout_flips(prog, gen, ntraj, len(ev.qubits), dev))
    return vals


# -- layered (shot-major) frame executor --------------------------------------

_IDENT_MBITS = 0x8421            # 4x4 identity over GF(2), bit i*4+j = M[i,j]
_MBITS_CACHE: dict = {}


def _gf2_mbits(u4: np.ndarray) -> int:
    """The 16-bit GF(2) matrix of a 2q Clifford's phase-free frame action:
    column j (inputs ordered x0, z0, x1, z1) = the conjugation table's image
    of basis pattern ``1 << j``; verified linear against all 16 patterns."""
    key = (u4.shape[0], u4.tobytes())
    hit = _MBITS_CACHE.get(key)
    if hit is not None:
        return hit
    tx, tz, _ = clifford_tables(u4)

    def outbits(c):
        return (tx[c] & 1, tz[c] & 1, (tx[c] >> 1) & 1, (tz[c] >> 1) & 1)

    mb = 0
    for j in range(4):
        for i, b in enumerate(outbits(1 << j)):
            mb |= int(b) << (i * 4 + j)
    for c in range(16):
        want = outbits(c)
        for i in range(4):
            got = 0
            for j in range(4):
                got ^= ((mb >> (i * 4 + j)) & 1) & ((c >> j) & 1)
            if got != want[i]:       # pragma: no cover - cannot happen
                raise AssertionError("non-linear frame action")
    _MBITS_CACHE[key] = mb
    return mb


def _build_layers(events, n: int, identity_noise_only: bool):
    """Pack EvGates/EvMeasure/EvReset into layers: gate prims batch greedily
    while their qubits stay disjoint; measure/reset events are layers of
    their own (split on a repeated qubit). Returns ``(layers, meas_slots,
    row_count)`` — layers as ``(kind, payload)``, meas_slots the
    program-order (layer, slot) of each measured qubit, row_count the row
    tape's length — or None when a prim has arity > 2."""
    from ..run.compiler import EvDump, EvGates, EvMeasure, EvReset

    ident2 = np.eye(2, dtype=np.complex128)
    layers: list[tuple[str, list]] = []
    meas_slots: list[tuple[int, int]] = []
    rows = 0
    cur: list | None = None
    cur_used: set = set()

    def flush():
        nonlocal cur, cur_used
        if cur:
            layers.append(("g", cur))
        cur = None
        cur_used = set()

    for ev in events:
        if isinstance(ev, EvGates):
            for p in ev.prims:
                t = p.targets
                rows += 1
                if len(t) == 1:
                    q = t[0]
                    dense = p.dense()
                    mb = _gf2_mbits(np.kron(np.eye(2, dtype=np.complex128), dense))
                    noisy = not identity_noise_only or np.allclose(dense, ident2)
                    entry = (n, q, mb, 0, 1 if noisy else 0, 0)
                    qs = {q}
                elif len(t) == 2:
                    mb = _gf2_mbits(p.dense())
                    f = 0 if identity_noise_only else 1
                    entry = (t[0], t[1], mb, f, f, f)
                    qs = set(t)
                else:
                    return None
                if cur is None or (qs & cur_used):
                    flush()
                    cur = []
                cur.append(entry)
                cur_used |= qs
        elif isinstance(ev, (EvMeasure, EvReset)):
            flush()
            kind = "m" if isinstance(ev, EvMeasure) else "r"
            chunk: list = []
            seen: set = set()
            for q in ev.qubits:
                rows += 1
                if q in seen:
                    layers.append((kind, chunk))
                    if kind == "m":
                        for si in range(len(chunk)):
                            meas_slots.append((len(layers) - 1, si))
                    chunk, seen = [], set()
                chunk.append(q)
                seen.add(q)
            layers.append((kind, chunk))
            if kind == "m":
                for si in range(len(chunk)):
                    meas_slots.append((len(layers) - 1, si))
        elif isinstance(ev, EvDump):
            continue
        else:      # pragma: no cover - eligibility is checked by the caller
            return None
    flush()
    if not layers:
        return None
    return layers, meas_slots, rows


def _pow2(v: int) -> int:
    return 1 << (v - 1).bit_length() if v > 1 else 1


def _pack_layers(layers, n: int):
    """Stack layers into uniform padded arrays (pads target the scratch
    row ``n`` with identity action and zero flags; slot counts round up to
    powers of two), as the JAX package's scan takes them."""
    P = _pow2(max((len(pl) for k, pl in layers if k == "g"), default=1))
    M = _pow2(max((len(pl) for k, pl in layers if k == "m"), default=1))
    R = _pow2(max((len(pl) for k, pl in layers if k == "r"), default=1))
    L = len(layers)
    q0 = np.full((L, P), n, np.int32)
    q1 = np.full((L, P), n, np.int32)
    mb = np.full((L, P), _IDENT_MBITS, np.uint32)
    nm = np.zeros((L, P, 2), np.uint32)
    nm2 = np.zeros((L, P), np.uint32)
    mq = np.full((L, M), n, np.int32)
    mvalid = np.zeros((L, M), np.uint32)
    rq = np.full((L, R), n, np.int32)
    noisy = np.zeros(L, bool)
    for li, (kind, pl) in enumerate(layers):
        if kind == "g":
            for pi, (a, b, m, f0, f1, f2) in enumerate(pl):
                q0[li, pi] = a
                q1[li, pi] = b
                mb[li, pi] = m
                nm[li, pi] = (f0, f1)
                nm2[li, pi] = f2
            noisy[li] = nm[li].any() or nm2[li].any()
        elif kind == "m":
            for si, q in enumerate(pl):
                mq[li, si] = q
                mvalid[li, si] = 1
        else:
            for si, q in enumerate(pl):
                rq[li, si] = q
    return q0, q1, mb, nm, nm2, mq, mvalid, rq, noisy


def _pack_traj_bits(bits: torch.Tensor, w: int) -> torch.Tensor:
    """(..., 32w) 0/1 ints -> (..., w) int32 words (bit t & 31 of word
    t >> 5 = trajectory t)."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (bits.reshape(*bits.shape[:-1], w, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _rand_words(gen, shape, dev) -> torch.Tensor:
    return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen, device=dev,
                         dtype=torch.int32)


def _layer_run(prog, layers, pk, fx, fz, gen, dev):
    """The layered scan over shot-major (n+1, Wt) frames: a gate layer
    gathers both slots' rows, applies each prim's GF(2) matrix by masked
    XOR folds, injects per-slot Pauli noise (one draw per noisy layer) and
    scatters back; a measure layer records the X rows and XORs random words
    into Z; a reset layer zeroes X and randomizes Z. Returns the records,
    one (slots, Wt) tensor per measure layer."""
    q0, q1, mb, nm, nm2, mq, _, rq, noisy = pk
    cdfs, cdfs2 = _cdfs(prog, dev)
    c1, c2 = cdfs.shape[0], cdfs2.shape[0]
    w = fx.shape[1]
    t = 32 * w
    up = {k: torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(dev)
          for k, a in (("q0", q0), ("q1", q1), ("mq", mq), ("rq", rq))}
    # the 16 mask bits of every prim's matrix, as 0 / -1 words: (L, P, 4, 4, 1)
    bits = torch.from_numpy(mb.astype(np.int64)).to(dev)[..., None] >> torch.arange(16, device=dev)
    masks = (-(bits & 1)).to(torch.int32).reshape(*mb.shape, 4, 4, 1)
    nmd = torch.from_numpy(nm.astype(np.int32)).to(dev)
    nm2d = torch.from_numpy(nm2.astype(np.int32)).to(dev)
    recs = []
    for li, (kind, pl) in enumerate(layers):
        k = len(pl)
        if kind == "g":
            a, b = up["q0"][li, :k], up["q1"][li, :k]
            ins = torch.stack([fx[a], fz[a], fx[b], fz[b]])          # (4, k, W)
            prod = masks[li, :k].permute(1, 2, 0, 3) & ins[None]      # (4, 4, k, W)
            outs = prod[:, 0] ^ prod[:, 1] ^ prod[:, 2] ^ prod[:, 3]
            if noisy[li] and (c1 or c2):
                u = torch.rand((2 * c1 + c2, k, t), generator=gen, device=dev)
                for ci in range(c1):
                    for sl in range(2):
                        c = (_pauli_index(cdfs[ci], u[2 * ci + sl].reshape(-1)).reshape(k, t)
                             * nmd[li, :k, sl, None])
                        outs[2 * sl] ^= _pack_traj_bits((c ^ (c >> 1)) & 1, w)
                        outs[2 * sl + 1] ^= _pack_traj_bits((c >> 1) & 1, w)
                for ci in range(c2):
                    c = (_pauli_index(cdfs2[ci], u[2 * c1 + ci].reshape(-1)).reshape(k, t)
                         * nm2d[li, :k, None])
                    for sl, sub in ((0, c >> 2), (1, c & 3)):
                        outs[2 * sl] ^= _pack_traj_bits((sub ^ (sub >> 1)) & 1, w)
                        outs[2 * sl + 1] ^= _pack_traj_bits((sub >> 1) & 1, w)
            fx[a] = outs[0]
            fx[b] = outs[2]
            fz[a] = outs[1]
            fz[b] = outs[3]
        elif kind == "m":
            m = up["mq"][li, :k]
            recs.append(fx[m])
            fz[m] = fz[m] ^ _rand_words(gen, (k, w), dev)
        else:
            r = up["rq"][li, :k]
            fx[r] = 0
            fz[r] = _rand_words(gen, (k, w), dev)
    return recs


def frame_run_vals_events(prog, events, ntraj: int, seed=None):
    """``ntraj`` noisy trajectories of a Clifford event stream WITH
    mid-circuit measurement/reset by Pauli frames: one exact tableau pass
    for the clean record, one frame scan for all trajectories, outcomes =
    clean XOR frame X at each measure row. The creg dict of ``run_vals``;
    None when a gate cannot be packed. Well-layerable tapes (the QEC shape)
    take the layered shot-major scan, pathologically interleaved ones the
    row scan (the JAX package's rule)."""
    n = prog.n
    ino = getattr(prog, "noise_identity_only", False)
    built = _build_layers(events, n, identity_noise_only=ino)
    if built is None:
        return None
    layers, meas_slots, row_count = built
    pk = _pack_layers(layers, n)
    pmax = max(pk[0].shape[1], pk[5].shape[1], pk[7].shape[1])
    if len(layers) * pmax > 8 * row_count:
        return _frame_run_vals_events_rows(prog, events, ntraj, seed)

    dev = device()
    gen = _gen(seed, dev)
    clean = _clean_record(n, events, torch.Generator().manual_seed(
        0 if seed is None else int(seed)), dev)
    w = (ntraj + 31) // 32
    fx = torch.zeros((n + 1, w), dtype=torch.int32, device=dev)
    # random Z on every qubit at t=0 (|0> is Z-invariant): the Stim trick
    # that decorrelates nondeterministic outcomes across trajectories
    fz = _rand_words(gen, (n + 1, w), dev)
    recs = _layer_run(prog, layers, pk, fx, fz, gen, dev)
    where, at = {}, 0
    for li, (kind, pl) in enumerate(layers):
        if kind == "m":
            where[li] = at
            at += len(pl)
    stats["syncs"] += 1
    rec = torch.cat(recs).cpu().numpy().view(np.uint32)             # (slots, Wt)
    j = np.arange(ntraj)
    flips = [((rec[where[li] + si, j >> 5] >> (j & 31)) & 1).astype(np.uint8)
             for (li, si) in meas_slots]
    return _events_vals(prog, events, ntraj, clean, flips, gen, dev)


def _frame_run_vals_events_rows(prog, events, ntraj: int, seed=None):
    """The row-scan form of :func:`frame_run_vals_events` (one tape row
    per prim / measured / reset qubit, trajectory-major (T, W) frames), for
    tapes whose layering would pad pathologically. Same semantics; its
    random stream differs."""
    n = prog.n
    packed = _pack_frame_tape(events, n, getattr(prog, "noise_identity_only", False))
    if packed is None:
        return None
    codes, t0, t1, txs, tzs, fl1, fl2, meas_rows = packed
    dev = device()
    gen = _gen(seed, dev)
    clean = _clean_record(n, events, torch.Generator().manual_seed(
        0 if seed is None else int(seed)), dev)
    words = (n + 31) // 32
    fx = torch.zeros((ntraj, words), dtype=torch.int32, device=dev)
    # frames start with random Z on every qubit (see frame_run_vals_events)
    fz = _rand_words(gen, (ntraj, words), dev)
    cdfs, cdfs2 = _cdfs(prog, dev)
    c1, c2 = cdfs.shape[0], cdfs2.shape[0]
    c = np.arange(16)
    xin = (c & 1) | (((c >> 2) & 1) << 1)
    zin = ((c >> 1) & 1) | (((c >> 3) & 1) << 1)
    tables = torch.from_numpy(((txs ^ xin) | ((tzs ^ zin) << 2)).astype(np.int32)).to(dev)
    gate_rows = [r for r, code in enumerate(codes) if code == _FOP_GATE]
    total = sum(c1 * int(fl1[r].sum()) + c2 * int(fl2[r]) for r in gate_rows)
    total += int(sum(code in (_FOP_MEASURE, _FOP_RESET) for code in codes))
    us = _Uniforms(gen, ntraj, total, dev)
    recs = {}
    for r, code in enumerate(codes):
        q0, q1 = int(t0[r]), int(t1[r])
        if code in (_FOP_GATE, _FOP_GATEQ):
            _apply_table(fx, fz, None, (q0, q1), tables[r])
            if code == _FOP_GATE:
                for ci in range(c1):
                    for j, q in enumerate((q0, q1)):
                        if fl1[r, j]:
                            _inject(fx, fz, q, _pauli_index(cdfs[ci], us.take(1)[0]))
                if fl2[r]:
                    for ci in range(c2):
                        cc = _pauli_index(cdfs2[ci], us.take(1)[0])
                        _inject(fx, fz, q0, cc >> 2)
                        _inject(fx, fz, q1, cc & 3)
        elif code == _FOP_MEASURE:
            recs[r] = _bit(fx, q0).to(torch.uint8)
            _flip_col(fz, q0, (us.take(1)[0] < 0.5).to(torch.int32))
        elif code == _FOP_RESET:
            _flip_col(fx, q0, _bit(fx, q0))
            _flip_col(fz, q0, _bit(fz, q0) ^ (us.take(1)[0] < 0.5).to(torch.int32))
    stats["syncs"] += 1
    rec = torch.stack([recs[r] for r in meas_rows]).cpu().numpy() if meas_rows else None
    flips = [rec[i] for i in range(len(meas_rows))]
    return _events_vals(prog, events, ntraj, clean, flips, gen, dev)
