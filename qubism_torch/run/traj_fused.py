"""Noisy trajectories through the kernels: the fused trajectory engine.

Counterpart of qubism_tpu/run/traj_fused.py. The vmapped engine
(``run/noisy.py``) applies every gate, channel branch and measurement to a
whole batch with generic torch ops, several state passes each. This engine
runs each trajectory through the SAME kernels as the noiseless engine, one
pass per fused step, with the content of every step in a small operand:

* runs of disjoint 1q gates (gate x realized Pauli folded) on row qubits
  apply as :func:`~qubism_torch.ops.kernels.layer1q_dev` passes (K4, up to
  six gates a pass), 1q gates on the lane qubits fold (kron on the device)
  into ONE 128-wide :func:`~qubism_torch.ops.kernels.lane_dev` product (K3);
* 2q gates (noise folded in, consecutive gates composed into blocks of up
  to 3 qubits) apply via :func:`~qubism_torch.ops.kernels.gate_dev` (K1), or
  K3 when every target is a lane qubit;
* the final measurement is ONE joint Born sample from |psi|^2 (equivalent
  to the reference's sequential per-qubit measurement,
  src/Qubism/StateVec.hs:133-137, under the correct Born rule).

**Noise realization.** Mixed-unitary channels (depolarizing, Pauli,
bit/phase-flip) have state-independent branch probabilities: their branch
is drawn on the host and folded into the adjacent gate's operand, zero
extra passes. State-dependent 1q Kraus channels (amplitude/phase damping)
run as MCWF sites on the device: one marginal reduction gives the jump
probability, the branch comes from a pre-drawn uniform by
``torch.searchsorted``, and the chosen Kraus, scaled by 1/sqrt(p_j), is
either DEFERRED (composed into the next operand that touches its qubit) or
applied through K4/K3 in their device-operand modes. Mid-circuit
measurement, reset and feed-forward (``if``) run on the device too: a
marginal table, the draws, one projection; a conditional operand is
selected against the identity by the predicate.

**Batches.** A batch's operands (realized on the host from
``np.random.default_rng(seed)``, in the JAX engine's draw order, so the
realized operands equal its trajectory by trajectory) are stacked in pinned
host memory and uploaded once; then a host loop launches each trajectory's
steps on ONE state buffer, with no host read until the batch's samples and
registers come back. The Born draws take their own uniforms, from a CPU
``torch.Generator`` seeded with ``seed``.

Eligibility is checked (:class:`FusedUnsupported`, with the JAX package's
messages; ``engine="auto"`` then takes the vmapped engine).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config
from ..ops import apply as A
from ..ops import kernels
from ..ops import measure as M
from ..ops.sample import sample_into
from .compiler import EvDump, EvGates, EvMeasure

_PAULI_ID = np.eye(2, dtype=np.complex128)

#: cap on the stacked operands of one batch (bytes): bounds the pinned
#: buffer and its device copy
_BATCH_OPERAND_CAP = 256 << 20

#: 1q gates per K4 pass (the kernel's register budget)
_LAYER1Q_MAX = kernels._LAYER1Q_MAX


class FusedUnsupported(ValueError):
    """This program/noise shape cannot take the fused trajectory path."""


def _expand_1q_to_slot(m: np.ndarray, pos: int, k: int) -> np.ndarray:
    """kron-expand a 2x2 onto axis ``pos`` of a k-target slot."""
    out = np.eye(1, dtype=np.complex128)
    for j in range(k):
        out = np.kron(out, m if j == pos else _PAULI_ID)
    return out


class _Site:
    """One host-realized stochastic noise site: a static CDF and the branch
    unitaries (pre-expanded to the owning slot's 2^k x 2^k dims when
    folded)."""

    __slots__ = ("cdf", "mats")

    def __init__(self, cdf: np.ndarray, mats: np.ndarray):
        self.cdf = np.asarray(cdf, dtype=np.float64)
        self.mats = mats  # (branches, 2^k, 2^k) complex

    def realize(self, u: float) -> np.ndarray:
        j = min(int(np.searchsorted(self.cdf, u, side="right")), len(self.cdf) - 1)
        return self.mats[j]


class _Slot:
    """One or more COMPOSED gates plus their noise sites, in program order,
    on a shared sorted target set. ``parts`` is the ordered composition:
    ("fix", matrix) for deterministic gate factors, ("site", _Site) for
    stochastic insertions, so merged slots keep the exact gate/noise
    interleaving of the original stream. ``cond_path`` is the enclosing
    feed-forward conditional chain (cond ids): the executor selects the
    realized operand against identity when the predicate misses, so a
    conditional gate costs zero extra passes."""

    __slots__ = ("targets", "parts", "cond_path")

    def __init__(self, targets, base=None, sites=(), parts=None, cond_path=()):
        self.targets = targets
        self.cond_path = tuple(cond_path)
        if parts is not None:
            self.parts = parts
        else:
            self.parts = [("fix", base)] + [("site", s) for s in sites]

    def realize(self, us) -> np.ndarray:
        m = None
        i = 0
        for kind, payload in self.parts:
            f = payload if kind == "fix" else payload.realize(us[i])
            if kind == "site":
                i += 1
            m = f if m is None else f @ m
        return m

    @property
    def n_sites(self) -> int:
        return sum(1 for k, _ in self.parts if k == "site")


def _expand_to(m: np.ndarray, src, dst) -> np.ndarray:
    """Embed a matrix on ``src`` targets into the ``dst`` target set (src a
    subset of dst, both in MSB-first axis order)."""
    k = len(dst)
    pad = k - len(src)
    m2 = np.kron(np.asarray(m, np.complex128), np.eye(1 << pad, dtype=np.complex128))
    cur = list(src) + [q for q in dst if q not in src]
    perm = [cur.index(q) for q in dst]
    return (m2.reshape((2,) * (2 * k)).transpose(perm + [k + p for p in perm])
            .reshape(1 << k, 1 << k))


#: merged-slot width cap: an all-dense 3q block is 8 complex MACs per
#: amplitude, still bound by the memory on K1
_MAX_MERGE_TARGETS = 3


def _maybe_merge(a: _Slot, b: _Slot):
    """Compose slot b AFTER slot a on the union target set, or None when the
    merge is not profitable (too wide, or a disjoint-1q pair that the layer
    pass already handles in one sweep) or ILLEGAL (different feed-forward
    predicates select different operands)."""
    if a.cond_path != b.cond_path:
        return None
    dst = tuple(sorted(set(a.targets) | set(b.targets)))
    if len(dst) > _MAX_MERGE_TARGETS:
        return None
    if len(a.targets) == 1 and len(b.targets) == 1 and a.targets != b.targets:
        return None

    def lift(slot):
        out = []
        for kind, payload in slot.parts:
            if kind == "fix":
                out.append(("fix", _expand_to(payload, slot.targets, dst)))
            else:
                out.append(("site", _Site(payload.cdf, np.stack(
                    [_expand_to(m, slot.targets, dst) for m in payload.mats]))))
        return out

    return _Slot(dst, parts=lift(a) + lift(b), cond_path=a.cond_path)


class _Mcwf:
    """A state-dependent 1q Kraus channel prepared for device MCWF: every
    K^dag K must be diagonal (true for amplitude/phase damping), so branch
    probabilities are p_j = a_j*P0 + b_j*P1 from one marginal.

    ``monomial`` marks the stronger property that every branch has at most
    one nonzero per COLUMN (ad's {diag, jump}, pd, any Pauli mix): then a
    branch's effect on computational-basis weights is a pure
    reweight-and-REMAP (``rmap[j, b]`` = the row column b maps to), the
    condition for the deferred-Kraus group path to track marginals exactly.
    Diagonal-K^dag-K channels that are NOT monomial still run, via the
    per-site apply step."""

    __slots__ = ("k", "ab", "monomial", "rmap", "_dev")

    def __init__(self, kraus):
        ks = [np.asarray(k, dtype=np.complex128) for k in kraus]
        ab = []
        rmap = []
        self.monomial = True
        for k in ks:
            if k.shape != (2, 2):
                raise FusedUnsupported(
                    "state-dependent Kraus channels on the fused path must be single-qubit")
            g = k.conj().T @ k
            if abs(g[0, 1]) > 1e-9 or abs(g[1, 0]) > 1e-9:
                raise FusedUnsupported(
                    "state-dependent Kraus channel with non-diagonal "
                    "K^dag K: needs per-branch norm sweeps; use the "
                    "vmapped engine")
            ab.append((float(g[0, 0].real), float(g[1, 1].real)))
            cols = np.abs(k) > 1e-9
            if (cols.sum(axis=0) > 1).any():
                self.monomial = False
            rmap.append(tuple(int(np.argmax(np.abs(k[:, b]))) for b in range(2)))
        self.k = np.stack(ks).astype(np.complex64)                # (B, 2, 2)
        self.ab = np.asarray(ab, dtype=np.float32)                # (B, 2)
        self.rmap = np.asarray(rmap, dtype=np.float32)            # (B, 2)
        self._dev = {}

    def on(self, dev):
        """(K, ab, rmap) as tensors on ``dev``."""
        if dev not in self._dev:
            self._dev[dev] = tuple(torch.from_numpy(a).to(dev)
                                   for a in (self.k, self.ab, self.rmap))
        return self._dev[dev]


#: mid-circuit measure/reset events wider than this use the vmapped engine
#: (their 2^k marginal table stops being "tiny")
_MID_MEASURE_MAX = 12


def _build_units(tprog):
    """Walk the program's events into execution units: ("slot", _Slot) for
    gates with folded mixed-unitary noise, ("mcwf", q, _Mcwf, path) for
    device norm-branch sites, ("measure"/"reset", ev, path) for mid-circuit
    collapses, ("cond", cid, creg, value, path) for feed-forward predicate
    evaluation points. The TRAILING run of unconditional measure events
    stays out of the unit stream: it is the one joint Born sample.
    Validates eligibility."""
    if config.reference_sqrt_born:
        raise FusedUnsupported(
            "reference sqrt-Born sampling is sequential-per-qubit; the "
            "fused path's joint Born sample matches only the correct rule")
    chans = []
    for (variants, is2q), (_, raw_ks, _) in zip(tprog._kchans, tprog.noise):
        if all(kind == "umix" for kind, _ in variants):
            nv = [(np.asarray(cdf), np.asarray(mats).astype(np.complex128))
                  for _, (cdf, mats) in variants]
            chans.append(("umix", nv, is2q))
        else:
            if is2q:
                raise FusedUnsupported(
                    "state-dependent 2q Kraus channels: use the vmapped engine")
            chans.append(("mcwf", _Mcwf(raw_ks), False))

    from .compiler import EvCond, EvReset

    units: list[tuple] = []
    cond_ids = iter(range(1 << 30))

    def emit_gates(ev, path):
        for p in ev.prims:
            if len(p.targets) > 2:
                raise FusedUnsupported(f"{len(p.targets)}-target primitive")
            u = np.asarray(p.dense() if p.diag else p.u, dtype=np.complex128)
            u, targets = A._sort_targets(u, tuple(p.targets))
            k = len(targets)
            fold: list[_Site] = []
            post: list[tuple] = []   # ("mcwf", ...) | ("slot", _Slot)
            post_qubits: set[int] = set()

            def emit_umix(cdf, mats, qubits, pos=None):
                """Fold when order allows (commutes past post sites on other
                qubits); otherwise a standalone realized unit."""
                if not (set(qubits) & post_qubits):
                    if pos is not None:
                        mats = np.stack([_expand_1q_to_slot(m, pos, k) for m in mats])
                    fold.append(_Site(cdf, mats))
                else:
                    post.append(("slot", _Slot(
                        tuple(sorted(qubits)), np.eye(mats.shape[-1], dtype=np.complex128),
                        [_Site(cdf, mats)], cond_path=path)))

            for (kind, payload, is2q), tset in zip(chans, tprog._tsets):
                if is2q:
                    if len(p.targets) != 2:
                        continue
                    if tset is not None and not set(int(q) for q in p.targets) <= tset:
                        continue   # targeted coupler channel
                    # as the vmapped engine: descending call-site targets
                    # pick the SWAP-conjugated variant, on sorted axes
                    cdf, mats = payload[p.targets[0] > p.targets[1]]
                    emit_umix(cdf, np.asarray(mats), targets)
                elif kind == "umix":
                    cdf, mats = payload[0]
                    for q in p.targets:
                        if tset is not None and int(q) not in tset:
                            continue
                        emit_umix(cdf, np.asarray(mats), (int(q),), pos=targets.index(int(q)))
                else:   # mcwf
                    for q in p.targets:
                        if tset is not None and int(q) not in tset:
                            continue
                        post.append(("mcwf", int(q), payload, path))
                        post_qubits.add(int(q))
            units.append(("slot", _Slot(targets, u, fold, cond_path=path)))
            units.extend(post)

    def emit(ev, path):
        if isinstance(ev, EvGates):
            emit_gates(ev, path)
        elif isinstance(ev, EvMeasure):
            if len(ev.qubits) > _MID_MEASURE_MAX:
                raise FusedUnsupported(
                    f"mid-circuit measurement of {len(ev.qubits)} qubits: "
                    "use the vmapped engine")
            if len(set(ev.qubits)) != len(ev.qubits):
                raise FusedUnsupported(
                    "mid-circuit re-measurement of a qubit within one "
                    "event: use the vmapped engine")
            units.append(("measure", ev, path))
        elif isinstance(ev, EvReset):
            if len(ev.qubits) > _MID_MEASURE_MAX:
                raise FusedUnsupported(
                    f"reset of {len(ev.qubits)} qubits: use the vmapped engine")
            units.append(("reset", ev, path))
        elif isinstance(ev, EvCond):
            cid = next(cond_ids)
            units.append(("cond", cid, ev.creg, ev.value, path))
            for sub in ev.body:
                emit(sub, path + (cid,))
        elif isinstance(ev, EvDump):
            pass
        else:
            raise FusedUnsupported(f"{type(ev).__name__} events: use the vmapped engine")

    # the trailing unconditional-measure run is the one joint Born sample;
    # everything before it (conditional and mid-circuit measures included)
    # becomes step units
    evs = [ev for ev in tprog.events if not isinstance(ev, EvDump)]
    cut = len(evs)
    while cut and isinstance(evs[cut - 1], EvMeasure):
        cut -= 1
    measures: list[EvMeasure] = list(evs[cut:])
    for ev in evs[:cut]:
        emit(ev, ())
    return units, measures


# ---------------------------------------------------------------------------
# Operands formed on the device
# ---------------------------------------------------------------------------


def _lane_matrix(cs: torch.Tensor, positions, n: int) -> torch.Tensor:
    """The (L, L) lane-block matrix from per-gate 2x2 matrices ``cs`` (g, 2,
    2) on the lane qubits ``positions``, kron-expanded with identities on the
    untouched lane qubits (qubit b = MSB of the lane index)."""
    b = max(n - A._COL, 0)
    eye = torch.eye(2, dtype=cs.dtype, device=cs.device)
    m = None
    i = 0
    for q in range(b, n):
        if q in positions:
            g = cs[i]
            i += 1
        else:
            g = eye
        m = g if m is None else torch.kron(m, g)
    return m.contiguous()


def _expand(m: torch.Tensor, src, dst) -> torch.Tensor:
    """:func:`_expand_to` on the device: a (2^k, 2^k) matrix on ``src``
    embedded into the ``dst`` targets (src a subset of dst)."""
    k, kk = len(dst), len(src)
    if tuple(src) == tuple(dst):
        return m
    full = torch.kron(m, torch.eye(1 << (k - kk), dtype=m.dtype, device=m.device))
    cur = list(src) + [q for q in dst if q not in src]
    perm = [cur.index(q) for q in dst]
    return (full.reshape((2,) * (2 * k)).permute(perm + [k + p for p in perm])
            .reshape(1 << k, 1 << k).contiguous())


class _Eye:
    """Identity matrices on a device, by dimension."""

    def __init__(self, dev):
        self.dev = dev
        self._by_d = {}

    def __call__(self, d: int) -> torch.Tensor:
        if d not in self._by_d:
            self._by_d[d] = torch.eye(d, dtype=torch.complex64, device=self.dev)
        return self._by_d[d]


# ---------------------------------------------------------------------------
# Execution steps
# ---------------------------------------------------------------------------
#
# Every step's ``run(state, it, pend, ctx)`` updates the state in place and
# threads ``pend``: a dict of qubit -> complex64 (2, 2) device tensor of a
# chosen-but-UNAPPLIED MCWF Kraus composition. A pending operator commutes
# past gates on other qubits, so it is folded (a 2x2 matmul) into the next
# step that touches its qubit instead of paying a state pass of its own;
# whatever is still pending at a new MCWF group is accounted for by
# reweighting the group's joint marginal table (valid because every
# admitted Kraus has <= 1 nonzero per column, so any composition M keeps
# M^dag M diagonal), and a _FlushStep applies leftovers in ONE 1q layer
# when the table would outgrow ``_MCWF_TABLE_MAX`` bits.


class _Ctx:
    """Per-trajectory device state threaded through the steps: classical
    registers (int32 bit vectors, LSB-first columns, the vmapped engine's
    convention), the feed-forward predicates evaluated so far (cond id ->
    0-d bool tensor; nested hits already AND their parent) and ``alive``."""

    __slots__ = ("cregs", "preds", "alive", "eye")

    def __init__(self, cregs, eye):
        self.cregs = cregs
        self.preds = {}
        #: False once a projection-reset annihilated the state (resetting a
        #: qubit certain to be |1>: the reference's nonphysical collapse
        #: semantics, Simulation.hs:146-156; the dense engines define the
        #: result as the zero vector, whose measurement reads all-zero
        #: bits). None = no reset step can annihilate.
        self.alive = None
        self.eye = eye

    def pred(self, path):
        """The active predicate for a unit under ``path`` (None = no
        enclosing conditional)."""
        return self.preds[path[-1]] if path else None

    def sel(self, pred, cs: torch.Tensor) -> torch.Tensor:
        """Operand-level feed-forward: ``cs`` when ``pred`` hits, the
        identity otherwise."""
        return cs if pred is None else torch.where(pred, cs, self.eye(cs.shape[-1]))


class _CondEnterStep:
    """Evaluate `if (creg == value)` at its program position (cregs may
    change at any mid-circuit measurement) and record the hit, ANDed with
    the parent predicate for nested conditionals. Touches no state."""

    n_sites = 0

    def __init__(self, cid, creg, value, path, size):
        self.cid = cid
        self.creg = creg
        self.value = value
        self.path = path
        self.size = size
        self.fits = not (value >> size)
        self._want = np.asarray([(value >> k) & 1 for k in range(size)], dtype=np.int32)

    def bind(self, dev):
        self.want = torch.from_numpy(self._want).to(dev)
        self.never = torch.zeros((), dtype=torch.bool, device=dev)

    def realize(self, us):
        return []

    def run(self, state, it, pend, ctx):
        hit = (ctx.cregs[self.creg] == self.want).all() if self.fits else self.never
        parent = ctx.pred(self.path)
        if parent is not None:
            hit = parent & hit
        ctx.preds[self.cid] = hit


def _write_cregs(ctx, writes, reported, pred):
    """Store a measurement's reported bits (0-d int32 tensors) into the
    trajectory's registers, selected by ``pred``."""
    off = 0
    for creg, bit_index, count in writes:
        old = ctx.cregs[creg]
        if bit_index is None:
            val = torch.stack(reported[off:off + count])
            if val.shape[0] < old.shape[0]:
                val = torch.cat([val, old[val.shape[0]:]])
        else:
            val = old.clone()
            val[bit_index] = reported[off]
        ctx.cregs[creg] = val if pred is None else torch.where(pred, val, old)
        off += count


class _MidMeasureStep:
    """Mid-circuit measurement: ONE marginal-table sweep, the ancestral Born
    draws (operand uniforms), one projection of every measured qubit
    jointly. Under a feed-forward predicate the projection vectors and creg
    writes select against no-ops. Readout error flips the REPORTED bits only
    (the state collapses on the true outcome)."""

    def __init__(self, ev, n, path, readout_p):
        self.qubits = tuple(ev.qubits)
        self.writes = tuple(ev.writes)
        self.n = n
        self.path = path
        self.readout_p = float(readout_p) if readout_p else 0.0
        k = len(self.qubits)
        self.n_sites = k * (2 if self.readout_p else 1)

    def bind(self, dev):
        self.bits = M.bit_table(len(self.qubits), dev)
        self.proj = M.Projector(self.qubits, self.n, dev)

    def realize(self, us):
        return [np.asarray(us, dtype=np.float32)]

    def run(self, state, it, pend, ctx):
        us = next(it)
        k = len(self.qubits)
        cur = M.marginal_table_dev(state, self.n, self.qubits)
        outcomes, mask = M.ancestral_draws_dev(cur, self.qubits, us[:k], self.bits)
        mass = (cur * mask).sum()
        scale = torch.where(mass > 0, torch.rsqrt(mass), torch.zeros_like(mass))
        rowvec, colvec = self.proj.vectors(outcomes, scale)
        pred = ctx.pred(self.path)
        if pred is not None:
            rowvec = torch.where(pred, rowvec, torch.ones_like(rowvec))
            colvec = torch.where(pred, colvec, torch.ones_like(colvec))
        self.proj.apply(state, rowvec, colvec)
        reported = [o.to(torch.int32) for o in outcomes]
        if self.readout_p:
            p = np.float32(self.readout_p).item()
            reported = [r ^ (us[k + i] < p).to(torch.int32) for i, r in enumerate(reported)]
        _write_cregs(ctx, self.writes, reported, pred)


class _ResetStep:
    """Mid-circuit reset: the reference's projection-to-|0> semantics
    (collapse + renormalize, NO Born draw, Simulation.hs:146-156) as one
    marginal sweep + one projection, predicate-selectable."""

    n_sites = 0

    def __init__(self, ev, n, path):
        self.qubits = tuple(dict.fromkeys(ev.qubits))    # dedupe, ordered
        self.n = n
        self.path = path

    def bind(self, dev):
        k = len(self.qubits)
        self.mask0 = (1.0 - M.bit_table(k, dev)).prod(dim=0)
        self.proj = M.Projector(self.qubits, self.n, dev)

    def realize(self, us):
        return []

    def run(self, state, it, pend, ctx):
        cur = M.marginal_table_dev(state, self.n, self.qubits)
        mass = (cur * self.mask0).sum()
        scale = torch.where(mass > 0, torch.rsqrt(mass), torch.zeros_like(mass))
        rowvec, colvec = self.proj.vectors([0.0] * len(self.qubits), scale)
        pred = ctx.pred(self.path)
        killed = mass <= 0
        if pred is not None:
            rowvec = torch.where(pred, rowvec, torch.ones_like(rowvec))
            colvec = torch.where(pred, colvec, torch.ones_like(colvec))
            killed = pred & killed
        alive = ~killed
        ctx.alive = alive if ctx.alive is None else (ctx.alive & alive)
        self.proj.apply(state, rowvec, colvec)


def _row_layer_groups(qubits):
    """Row-layer qubits in passes of at most _LAYER1Q_MAX (the port's K4
    reaches any qubit the same way, so only the count splits a layer)."""
    qubits = list(qubits)
    return [qubits[i:i + _LAYER1Q_MAX] for i in range(0, len(qubits), _LAYER1Q_MAX)]


class _LayerStep:
    """A run of disjoint 1q slots: row qubits via K4 passes (six gates a
    pass), lane qubits folded (kron on the device) into one 128-wide K3
    product. ``absorb`` (set by the planner) lists pending-Kraus qubits
    composed into the matching slot's matrix."""

    def __init__(self, slots, n, absorb=()):
        b = max(n - A._COL, 0)
        self.row = sorted((s for s in slots if s.targets[0] < b), key=lambda s: s.targets[0])
        self.lane = sorted((s for s in slots if s.targets[0] >= b), key=lambda s: s.targets[0])
        self.n = n
        self.n_sites = sum(s.n_sites for s in self.row + self.lane)
        self.absorb_row = tuple((i, s.targets[0]) for i, s in enumerate(self.row)
                                if s.targets[0] in absorb)
        self.absorb_lane = tuple((i, s.targets[0]) for i, s in enumerate(self.lane)
                                 if s.targets[0] in absorb)
        self._row_groups = []              # (slice, qubits) per K4 pass
        off = 0
        for grp in _row_layer_groups(s.targets[0] for s in self.row):
            self._row_groups.append((slice(off, off + len(grp)), tuple(grp)))
            off += len(grp)
        self._lane_pos = tuple(s.targets[0] for s in self.lane)

    def bind(self, dev):
        pass

    def realize(self, us):
        mats, pos = [], 0
        for s in self.row + self.lane:
            mats.append(s.realize(us[pos:pos + s.n_sites]))
            pos += s.n_sites
        out = []
        nr = len(self.row)
        if self.row:
            out.append(np.stack(mats[:nr]).astype(np.complex64))
        if self.lane:
            out.append(np.stack(mats[nr:]).astype(np.complex64))
        return out

    @staticmethod
    def _operands(cs, slots, absorb, pend, ctx):
        orig = list(cs)
        rows = list(orig)
        for i, s in enumerate(slots):
            rows[i] = ctx.sel(ctx.pred(s.cond_path), rows[i])
        for i, q in absorb:
            rows[i] = rows[i] @ pend.pop(q)  # the pending Kraus first
        changed = any(r is not c for r, c in zip(rows, orig))
        return torch.stack(rows) if changed else cs

    def run(self, state, it, pend, ctx):
        if self.row:
            cs = self._operands(next(it), self.row, self.absorb_row, pend, ctx)
            for sl, qs in self._row_groups:
                kernels.layer1q_dev(state, cs[sl], qs, self.n)
        if self.lane:
            cs = self._operands(next(it), self.lane, self.absorb_lane, pend, ctx)
            kernels.lane_dev(state, _lane_matrix(cs, self._lane_pos, self.n), self.n)


class _DenseStep:
    """One >=2-target slot: K1 on the (2^k, 2^k) operand, or K3 when every
    target is a lane qubit. Pending Kraus on ``absorb`` qubits compose into
    the operand."""

    def __init__(self, slot, n, absorb=()):
        self.slot = slot
        self.n = n
        self.n_sites = slot.n_sites
        self.absorb = tuple(q for q in slot.targets if q in absorb)
        b = max(n - A._COL, 0)
        self.pure_lane = all(t >= b for t in slot.targets)

    def bind(self, dev):
        pass

    def realize(self, us):
        return [self.slot.realize(us).astype(np.complex64)]

    def run(self, state, it, pend, ctx):
        cs = ctx.sel(ctx.pred(self.slot.cond_path), next(it))
        for q in self.absorb:
            cs = cs @ _expand(pend.pop(q), (q,), self.slot.targets)
        if self.pure_lane:
            b = max(self.n - A._COL, 0)
            kernels.lane_dev(state, _expand(cs, self.slot.targets, tuple(range(b, self.n))),
                             self.n)
        else:
            kernels.gate_dev(state, cs.contiguous(), self.slot.targets, self.n)


class _FlushStep:
    """Apply every pending Kraus on ``qubits`` in ONE fused pass (they sit
    on distinct qubits, so a 1q layer covers all of them)."""

    n_sites = 0

    def __init__(self, qubits, n):
        b = max(n - A._COL, 0)
        self.n = n
        self.row_qs = tuple(sorted(q for q in qubits if q < b))
        self.lane_qs = tuple(sorted(q for q in qubits if q >= b))

    def bind(self, dev):
        pass

    def realize(self, us):
        return []

    def run(self, state, it, pend, ctx):
        for grp in _row_layer_groups(self.row_qs):
            kernels.layer1q_dev(state, torch.stack([pend.pop(q) for q in grp]), grp, self.n)
        if self.lane_qs:
            cs = torch.stack([pend.pop(q) for q in self.lane_qs])
            kernels.lane_dev(state, _lane_matrix(cs, self.lane_qs, self.n), self.n)


def _branch(mc_dev, u, p0, p1):
    """The MCWF branch drawn with ``u`` from P0, P1: (j (1,) int64, probs)."""
    _, ab, _ = mc_dev
    probs = ab[:, 0] * p0 + ab[:, 1] * p1                         # (B,)
    cdf = torch.cumsum(probs, 0)
    j = torch.searchsorted(cdf, (u * cdf[-1]).reshape(1), right=True)
    return j.clamp_(0, probs.shape[0] - 1), probs


class _McwfApplyStep:
    """Per-site MCWF for diagonal-K^dag-K channels whose branches are NOT
    monomial (orthogonal dense columns, e.g. a Hadamard-like branch): one
    (P0, P1) reduction on the CURRENT state, then the chosen renormalized
    Kraus applied as its own 1q pass. The planner flushes every pending
    Kraus first, so the reduction sees the true state."""

    n_sites = 1

    def __init__(self, q, mcwf, n, path=()):
        self.q, self.mc, self.n = q, mcwf, n
        self.path = path
        self.lane = q >= max(n - A._COL, 0)

    def bind(self, dev):
        self.dev_tables = self.mc.on(dev)

    def realize(self, us):
        return [np.float32(us[0])]

    def run(self, state, it, pend, ctx):
        assert not pend      # planner flushed before this step
        u = next(it)
        w = M.marginal_table_dev(state, self.n, (self.q,))
        p0, p1 = w[0], w[1]
        j, probs = _branch(self.dev_tables, u, p0, p1)
        inv = torch.rsqrt(torch.clamp(probs.index_select(0, j)[0]
                                      / torch.clamp(p0 + p1, min=1e-30), min=1e-30))
        coefs = ctx.sel(ctx.pred(self.path), self.dev_tables[0].index_select(0, j)[0] * inv)
        if self.lane:
            kernels.lane_dev(state, _lane_matrix(coefs[None], (self.q,), self.n), self.n)
        else:
            kernels.layer1q_dev(state, coefs[None].contiguous(), (self.q,), self.n)


#: joint-marginal width cap for an MCWF group (sites + pending qubits)
_MCWF_TABLE_MAX = 8


class _McwfGroupStep:
    """A run of MCWF norm-branch sites sharing ONE joint marginal: |a|^2
    reduces over everything but the sites' qubits and the currently-pending
    qubits; pending compositions reweight the table (their K^dag K is
    diagonal); each site's branch then draws from the table, updates it, and
    COMPOSES its chosen (renormalized) Kraus into ``pend`` instead of
    paying an apply pass."""

    def __init__(self, sites, tableqs, pend_qs, n):
        self.sites = tuple(sites)              # ordered (q, _Mcwf, path)
        self.tableqs = tuple(tableqs)          # sorted
        self.pend_qs = tuple(pend_qs)
        self.n = n
        self.n_sites = len(self.sites)

    def bind(self, dev):
        k = len(self.tableqs)
        bits = M.bit_table(k, dev)
        idx = torch.arange(1 << k, device=dev)
        self._mask1 = {q: bits[s] for s, q in enumerate(self.tableqs)}
        self._swap = {q: idx ^ (1 << (k - 1 - s)) for s, q in enumerate(self.tableqs)}
        self._mc = [mc.on(dev) for _, mc, _ in self.sites]

    def realize(self, us):
        return [np.asarray(us, dtype=np.float32)]

    def _remap(self, w, q, c0, c1, r0, r1):
        """Monomial-branch weight update on the table: column b of the chosen
        operator carries weight ``cb`` to bit value ``rb``: reweight both
        bit sectors AND move them to their target bit."""
        mask1 = self._mask1[q]
        w0 = w * (1.0 - mask1)
        w1 = w * mask1
        sw0 = w0.index_select(0, self._swap[q])       # b=0 weights at bit-1 slots
        sw1 = w1.index_select(0, self._swap[q])
        return c0 * ((1.0 - r0) * w0 + r0 * sw0) + c1 * (r1 * w1 + (1.0 - r1) * sw1)

    def run(self, state, it, pend, ctx):
        us = next(it)
        w = M.marginal_table_dev(state, self.n, self.tableqs)
        for q in self.pend_qs:
            a = pend[q].abs() ** 2              # |m[row, col]|^2
            c0, c1 = a[:, 0].sum(), a[:, 1].sum()      # K^dag K diagonal
            # monomial composition: the nonzero row of each column
            r0 = (a[1, 0] > a[0, 0]).to(torch.float32)
            r1 = (a[1, 1] > a[0, 1]).to(torch.float32)
            w = self._remap(w, q, c0, c1, r0, r1)
        for si, (q, _, path) in enumerate(self.sites):
            kmat, ab, rmap = self._mc[si]
            tot = w.sum()
            p1 = (w * self._mask1[q]).sum()
            p0 = torch.clamp(tot - p1, min=0.0)
            j, probs = _branch(self._mc[si], us[si], p0, p1)
            pj = torch.clamp(probs.index_select(0, j)[0], min=1e-30)
            inv = torch.sqrt(tot) * torch.rsqrt(pj)
            coef = kmat.index_select(0, j)[0] * inv
            abj, rj = ab.index_select(0, j)[0], rmap.index_select(0, j)[0]
            wn = self._remap(w, q, abj[0], abj[1], rj[0], rj[1]) * (tot / pj)
            pred = ctx.pred(path)
            if pred is not None:
                coef = ctx.sel(pred, coef)
                wn = torch.where(pred, wn, w)
            prev = pend.get(q)
            pend[q] = coef if prev is None else coef @ prev
            # keep w the weights of the TRUE (renormalized) state so the
            # next site's conditionals read straight off it
            w = wn


def _pack(arrays, align: int = 16):
    """Host arrays -> (one pinned uint8 buffer holding them all, their
    (offset, dtype, shape)), each at an offset aligned to ``align`` bytes."""
    spans, off = [], 0
    for a in arrays:
        spans.append((off, a.dtype, a.shape))
        off += -(-a.nbytes // align) * align
    pin = torch.cuda.is_available()
    buf = torch.empty(max(off, align), dtype=torch.uint8, pin_memory=pin)
    host = buf.numpy()
    for a, (o, _, _) in zip(arrays, spans):
        host[o:o + a.nbytes] = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
    return buf, spans


def _unpack(buf: torch.Tensor, spans):
    """Typed views of the arrays of a packed (uploaded) buffer."""
    out = []
    for o, dtype, shape in spans:
        tdt = {np.dtype(np.complex64): torch.complex64, np.dtype(np.float32): torch.float32,
               np.dtype(np.float64): torch.float64}[np.dtype(dtype)]
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        out.append(buf[o:o + nbytes].view(tdt).view(shape))
    return out


class FusedTrajectories:
    """Plan once, then run trajectory batches as realized-operand sweeps
    through the kernels, one upload per batch."""

    #: set to "error" (or "warn") to run each batch's launches, from its
    #: upload to the read-back, under ``torch.cuda.set_sync_debug_mode``:
    #: a synchronising call there then raises
    sync_debug: str | None = None

    def __init__(self, tprog):
        self.tprog = tprog
        self.n = tprog.n
        if self.n < 2:
            raise FusedUnsupported("need >= 2 qubits")
        units, self.measures = _build_units(tprog)
        #: any mid-circuit measurement step (cregs come back from the batch)
        self.has_mid = False

        # greedy slot merging: compose consecutive gates (noise sites kept
        # in order) into <= _MAX_MERGE_TARGETS-qubit dense blocks: a CX
        # ladder's one-pass-per-gate stream collapses ~2x (a GHZ-26
        # trajectory: 27 -> ~14 passes). MCWF units are natural barriers
        # (state-dependent: cannot commute into a composition).
        fused: list[tuple] = []
        for unit in units:
            if unit[0] == "slot" and fused and fused[-1][0] == "slot":
                m = _maybe_merge(fused[-1][1], unit[1])
                if m is not None:
                    fused[-1] = ("slot", m)
                    continue
            fused.append(unit)
        units = fused

        # group units into steps: greedy disjoint-1q layers, dense slots,
        # MCWF groups. ``pend_set`` statically tracks which qubits carry a
        # deferred (chosen-but-unapplied) Kraus at each point: gate steps
        # absorb them, MCWF groups reweight their tables by them, and a
        # _FlushStep applies leftovers when a group's table would outgrow
        # _MCWF_TABLE_MAX bits (and once at the end, before sampling).
        steps: list = []
        lay: list[_Slot] = []
        used: set[int] = set()
        pend_set: list[int] = []

        def flush_layer():
            nonlocal lay, used
            if lay:
                absorb = {s.targets[0] for s in lay} & set(pend_set)
                steps.append(_LayerStep(lay, self.n, absorb=absorb))
                for q in absorb:
                    pend_set.remove(q)
                lay, used = [], set()

        def flush_pend():
            nonlocal pend_set
            if pend_set:
                steps.append(_FlushStep(tuple(pend_set), self.n))
                pend_set = []

        i = 0
        while i < len(units):
            unit = units[i]
            if unit[0] == "mcwf":
                flush_layer()
                if not unit[2].monomial:
                    # interference within a basis sector: marginal tables
                    # cannot track it; apply per site on the true state
                    flush_pend()
                    steps.append(_McwfApplyStep(unit[1], unit[2], self.n, unit[3]))
                    i += 1
                    continue
                run = []
                while i < len(units) and units[i][0] == "mcwf" and units[i][2].monomial:
                    run.append((units[i][1], units[i][2], units[i][3]))
                    i += 1
                while run:
                    chunk: list = []
                    cq: set[int] = set()
                    while run and len(cq | {run[0][0]}) <= _MCWF_TABLE_MAX:
                        q, mc, path = run.pop(0)
                        chunk.append((q, mc, path))
                        cq.add(q)
                    tqs = sorted(cq | set(pend_set))
                    if len(tqs) > _MCWF_TABLE_MAX:
                        flush_pend()
                        tqs = sorted(cq)
                    steps.append(_McwfGroupStep(chunk, tqs, tuple(pend_set), self.n))
                    for q, _, _ in chunk:
                        if q not in pend_set:
                            pend_set.append(q)
                continue
            if unit[0] == "cond":
                _, cid, creg, value, path = unit
                steps.append(_CondEnterStep(cid, creg, value, path, tprog.creg_sizes[creg]))
                i += 1
                continue
            if unit[0] == "measure":
                flush_layer()
                flush_pend()    # the marginal must see the true state
                steps.append(_MidMeasureStep(unit[1], self.n, unit[2], tprog.readout_p))
                self.has_mid = True
                i += 1
                continue
            if unit[0] == "reset":
                flush_layer()
                flush_pend()
                steps.append(_ResetStep(unit[1], self.n, unit[2]))
                i += 1
                continue
            s = unit[1]
            i += 1
            if len(s.targets) == 1:
                if s.targets[0] in used:
                    flush_layer()
                lay.append(s)
                used.add(s.targets[0])
            else:
                flush_layer()
                absorb = set(s.targets) & set(pend_set)
                steps.append(_DenseStep(s, self.n, absorb=absorb))
                for q in absorb:
                    pend_set.remove(q)
        flush_layer()
        flush_pend()
        self.steps = steps

        #: total stochastic sites, in step order (one uniform each)
        self.total_sites = sum(st.n_sites for st in self.steps)
        #: trajectory batches run by run_vals (one upload and one read-back
        #: each)
        self.dispatch_count = 0
        self._bound = None

    def _bind(self, dev):
        """Make every step's device constants on ``dev`` (once per device)."""
        if self._bound != dev:
            for st in self.steps:
                st.bind(dev)
            self._bound = dev

    # -- realization ----------------------------------------------------------

    def _realize_operands(self, rng):
        """Draw every site's branch/uniform and build the per-step operand
        lists for ONE trajectory."""
        us = rng.random(self.total_sites)
        pos = 0
        per_step = []
        for st in self.steps:
            per_step.append(st.realize(us[pos:pos + st.n_sites]))
            pos += st.n_sites
        return per_step

    # -- one trajectory on the device --------------------------------------------

    def _run_one(self, state, ops, eye):
        """One trajectory: |0..0> -> all steps, in place on ``state``, with
        ``ops`` its device operands in step order. Returns its context
        (registers, ``alive``)."""
        dev = state.device
        state.zero_()
        state[:1].fill_(1)  # a scalar fill: no copy from the host
        pend: dict = {}
        ctx = _Ctx({c: torch.zeros(self.tprog.creg_sizes[c], dtype=torch.int32, device=dev)
                    for c in self.tprog.creg_names}, eye)
        it = iter(ops)
        for st in self.steps:
            st.run(state, it, pend, ctx)
        assert not pend, "planner left a Kraus pending past the last flush"
        return ctx

    def final_state(self, ops) -> torch.Tensor:
        """The final state of one trajectory from its realized host operands
        (``_realize_operands`` flattened), on ``config.device``."""
        dev = A.device()
        self._bind(dev)
        state = torch.empty(1 << self.n, dtype=torch.complex64, device=dev)
        dops = [torch.from_numpy(np.asarray(o)).to(dev) for o in ops]
        self._run_one(state, dops, _Eye(dev))
        return state

    # -- host API -------------------------------------------------------------

    def _auto_batch(self, ops0, ntraj: int) -> int:
        per = sum(int(np.asarray(o).nbytes) for o in ops0) + 8
        return int(max(1, min(ntraj, _BATCH_OPERAND_CAP // max(per, 1))))

    def _run_batch(self, state, per_traj, born, eye, out_idx, out_cregs):
        """Upload one batch's operands (one pinned buffer, one copy), launch
        every trajectory's steps and sample, then read the batch back."""
        dev = state.device
        cnt = len(per_traj)
        n_ops = len(per_traj[0])
        stacked = [np.stack([np.asarray(per_traj[t][i]) for t in range(cnt)])
                   for i in range(n_ops)] + [born]
        buf, spans = _pack(stacked)
        cuda = dev.type == "cuda"
        if cuda and self.sync_debug:
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(self.sync_debug)
        try:
            views = _unpack(buf.to(dev, non_blocking=True), spans)
            ops, u = views[:-1], views[-1]
            idx = torch.zeros(cnt, dtype=torch.int64, device=dev)
            cregs = {c: torch.zeros((cnt, self.tprog.creg_sizes[c]), dtype=torch.int32,
                                    device=dev) for c in self.tprog.creg_names}
            for t in range(cnt):
                ctx = self._run_one(state, [o[t] for o in ops], eye)
                if self.measures:
                    sample_into(state, self.n, u[t:t + 1], idx[t:t + 1], ctx.alive)
                for c in self.tprog.creg_names:
                    cregs[c][t].copy_(ctx.cregs[c])
        finally:
            if cuda and self.sync_debug:
                torch.cuda.set_sync_debug_mode(prev)
        out_idx.extend(idx.cpu().numpy().tolist())
        for c in self.tprog.creg_names:
            out_cregs[c].append(cregs[c].cpu().numpy())
        self.dispatch_count += 1

    def run_vals(self, ntraj: int, seed: int | None = None, batch: int | None = None):
        """Same output contract as ``TrajectoryProgram.run_vals``: dict creg
        name -> (ntraj, size) int32 bit arrays (LSB-first columns). The
        random stream is this engine's own (numpy PCG64 seeded by ``seed``
        for noise realization, MCWF and mid-circuit uniforms and readout;
        a CPU ``torch.Generator`` seeded by ``seed`` for the Born draws):
        statistically equivalent to, not bit-identical with, the vmapped
        engine's. ``batch`` overrides the operand-budget batch size; results
        do not depend on it (each trajectory runs alone on the state)."""
        if batch is not None:
            batch = int(batch)
            if batch < 1:
                raise ValueError(f"batch must be >= 1, got {batch}")
        tprog = self.tprog
        rng = np.random.default_rng(0 if seed is None else seed)
        out = {c: np.zeros((ntraj, tprog.creg_sizes[c]), dtype=np.int32)
               for c in tprog.creg_names}
        nbits = sum(len(ev.qubits) for ev in self.measures)
        per_traj, flips = [], []
        for _ in range(ntraj):
            ops = self._realize_operands(rng)
            per_traj.append([o for step_ops in ops for o in step_ops])
            if tprog.readout_p:
                # the per-trajectory engine's draw order: noise realization
                # first, then one reporting flip per read
                flips.append([rng.random() < tprog.readout_p for _ in range(nbits)])
        if ntraj == 0 or not (self.measures or self.has_mid):
            return out

        born = torch.rand(ntraj, generator=torch.Generator().manual_seed(
            0 if seed is None else int(seed)), dtype=torch.float64).numpy()
        dev = A.device()
        self._bind(dev)
        eye = _Eye(dev)
        state = torch.empty(1 << self.n, dtype=torch.complex64, device=dev)
        T = batch if batch is not None else self._auto_batch(per_traj[0], ntraj)
        idx: list[int] = []
        mid = {c: [] for c in tprog.creg_names}
        for lo in range(0, ntraj, T):
            hi = min(lo + T, ntraj)
            self._run_batch(state, per_traj[lo:hi], born[lo:hi], eye, idx, mid)
        del state
        if self.has_mid:
            # mid-circuit creg writes come back from the batches; the
            # final-measure writes below overwrite them in program order
            # (they are the trailing events)
            for c in tprog.creg_names:
                out[c][:] = np.concatenate(mid[c])

        for t in range(ntraj):
            k = 0
            for ev in self.measures:
                bits = []
                for q in ev.qubits:
                    b = (idx[t] >> (self.n - 1 - q)) & 1
                    # readout error flips each REPORTED bit independently
                    # per read (the state stays collapsed on the true bits)
                    if tprog.readout_p and flips[t][k]:
                        b ^= 1
                    k += 1
                    bits.append(b)
                off = 0
                for creg, bit_index, count in ev.writes:
                    if bit_index is None:
                        out[creg][t, :count] = bits[off:off + count]
                    else:
                        out[creg][t, bit_index] = bits[off]
                    off += count
        return out


def run_vals_fused(tprog, ntraj: int, seed: int | None = None):
    """One-shot helper: build the fused plan (kept on the program) and run.
    Raises :class:`FusedUnsupported` when the program shape does not
    qualify."""
    plan = getattr(tprog, "_fused_plan", None)
    if plan is None:
        plan = FusedTrajectories(tprog)
        tprog._fused_plan = plan
    return plan.run_vals(ntraj, seed=seed)
