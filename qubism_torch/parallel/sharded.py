"""Amplitude-sharded state-vector simulation over a mesh of devices.

Counterpart of qubism_tpu/parallel/sharded.py. Physical bit layout
(big-endian: qubit 0 is the most significant bit of the amplitude index):

* positions ``[0, d)``: **device** bits, which select one of the D = 2^d
  shards of the mesh;
* positions ``[d, d+w)``: **bank** bits, which select one of a shard's 2^w
  banks;
* positions ``[d+w, n)``: **local** bits, the index within a bank.

The state is ``banks[s][i]``: one contiguous complex64 tensor of 2^m
amplitudes (m = n - d - w) for bank s of shard i, on ``mesh[i]``. The mesh is
a tuple of torch devices (``make_mesh``), and a device may repeat: four
shards on one card run the mesh's code paths without a second card.

How each operation runs:

* dense gates on local targets: per bank, the fused plans of the single-device
  engine (``fusion.fuse`` / ``fusion.plan``, the K1-K5 wrappers);
* dense gates on bank targets only: K6 (``kernels.shard_butterfly``), one
  launch per group of banks that differ only in the target bits;
* dense gates on bank and local targets: a block decomposition over the bank
  bits, ``out_bank = sum_in blk[out, in]`` applied on the local targets of
  bank ``in``, with identity blocks passed through and zero blocks skipped;
* dense gates on device targets: a **relabelling swap** first exchanges the
  device bit with a local bit (half of every bank of each shard goes to its
  partner shard), tracked in the logical -> physical permutation ``perm``;
* diagonals on any targets: no exchange. The host picks each shard's and
  each bank's slice of the table; local targets go to K2, none to a scalar;
* measurement: per-bank reductions summed in float64 on the host; shot
  sampling: an inverse CDF over shards, then banks, then local indices.

Left out, as what the JAX package did for its TPU stack and its remote
dispatch: jit caches, the chunking of segments into sub-programs and the
draining of the dispatch queue.

* Pauli expectations: the device and bank bits of a string's flip mask pick
  each bank's partner bank, their Y/Z bits give a sign per bank, and the local
  bits go through ``measure.pauli_pair_sums`` on the pair of banks; a partner
  on another device is read chunk by chunk. Summed in float64 on the host.
"""

from __future__ import annotations

import collections
import hashlib
import math

import numpy as np
import torch

from ..config import config
from ..core.gates import Prim
from ..ops import apply as _apply
from ..ops import kernels
from ..ops import measure as _measure
from ..ops import sample as _sample
from ..ops.fusion import MAX_BLOCK, DenseOp, DiagLayer, fuse, plan, split_op_virtual
from .mesh import make_mesh

#: A bank holds at most 2^LOCAL_MAX amplitudes. The JAX package chose it
#: because its TPU stack rejected buffers past 2^29 float32 elements; a CUDA
#: device has no such limit, but the port keeps it so that its layout, and
#: which ops run through K6, are the JAX package's at every n (the parity
#: tests rely on it). PERF.md records what the banks cost on the card.
LOCAL_MAX = 29

#: amplitudes per chunk of the device <-> local exchange (its only scratch)
_SWAP_CHUNK = 1 << 24

#: lowered segments kept (each holds its uploaded kernel operands)
_LOWERED_LRU = 32


def default_banks(n: int, d: int) -> int:
    """log2 of the bank count that keeps a bank at <= 2^LOCAL_MAX amplitudes."""
    return max(0, n - d - LOCAL_MAX)


def _norm2(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t)) ** 2


def _field(bit, positions) -> int:
    """The integer whose bits, MSB first, are ``bit(p)`` for p in
    ``positions``."""
    out = 0
    for p in positions:
        out = (out << 1) | bit(p)
    return out


def _exchange(a: torch.Tensor, b: torch.Tensor):
    """Swap the contents of two equal-shaped (A, L) views, in chunks of at
    most _SWAP_CHUNK amplitudes through one scratch buffer on ``a``'s
    device; ``b`` may live on another device (the copies then go peer to
    peer)."""
    A, L = a.shape
    buf = torch.empty(min(A * L, _SWAP_CHUNK), dtype=a.dtype, device=a.device)
    if L >= _SWAP_CHUNK:
        parts = ((r, slice(c, c + _SWAP_CHUNK)) for r in range(A) for c in range(0, L, _SWAP_CHUNK))
    else:
        step = _SWAP_CHUNK // L
        parts = ((slice(r, r + step), slice(None)) for r in range(0, A, step))
    for idx in parts:
        x, y = a[idx], b[idx]
        t = buf[:x.numel()].view(x.shape)
        t.copy_(x)
        x.copy_(y)
        y.copy_(t)


class ShardedSim:
    """An n-qubit state vector sharded over a mesh of devices, each shard in
    2^w banks.

    ``mesh``: a sequence of torch devices (repeats allowed), or None for
    :func:`make_mesh`'s default. ``banks``: w, default
    :func:`default_banks`. ``allocate=False`` plans without a state."""

    def __init__(self, n: int, mesh=None, banks: int | None = None, allocate: bool = True):
        mesh = make_mesh() if mesh is None else mesh
        self.mesh = tuple(_apply.canonical_device(dv) for dv in mesh)
        self.D = len(self.mesh)
        self.d = self.D.bit_length() - 1
        if self.D < 1 or (1 << self.d) != self.D:
            raise ValueError(f"mesh size {self.D} is not a power of two")
        if len({dv.type for dv in self.mesh}) != 1:
            raise ValueError(f"mesh mixes device types: {self.mesh}")
        if n < self.d:
            raise ValueError(f"need at least {self.d} qubits for {self.D} shards")
        self.w = default_banks(n, self.d) if banks is None else banks
        self.m = n - self.d - self.w
        if self.w < 0 or (self.m < 2 and n >= 2):
            raise ValueError(f"{self.D} shards x 2^{self.w} banks leave {self.m} local "
                             f"qubit(s); dense 2-qubit gates need 2")
        self.n = n
        #: logical qubit -> physical bit position, and its inverse
        self.perm = list(range(n))
        self.inv = list(range(n))
        #: banks[s][i]: bank s of shard i (None until allocated)
        self.banks = None
        #: segments run, relabelling swaps and measurements made
        self.dispatch_count = 0
        self._lowered: collections.OrderedDict = collections.OrderedDict()
        if allocate:
            self.reset_state()

    def reset_state(self):
        """Back to |0...0> with the identity labelling, keeping the lowered
        segments (repeated runs skip the lowering)."""
        self.banks = None  # free the old state before allocating the new one
        banks = [[torch.zeros(1 << self.m, dtype=torch.complex64, device=dv)
                  for dv in self.mesh] for _ in range(1 << self.w)]
        banks[0][0][0] = 1
        self.banks = banks
        self.perm = list(range(self.n))
        self.inv = list(range(self.n))
        return self

    # -- permutation bookkeeping ----------------------------------------------

    def _swap_positions(self, pg: int, pl: int):
        """Record that physical positions pg and pl exchanged contents."""
        lg, ll = self.inv[pg], self.inv[pl]
        self.perm[lg], self.perm[ll] = pl, pg
        self.inv[pg], self.inv[pl] = ll, lg

    # -- relabelling swap (device bit <-> local bit) ----------------------------

    def swap_global_local(self, pg: int, pl: int):
        """Exchange device position pg (< d) with local position pl (>= d+w):
        in every bank, the half of shard i (bit pg = 0) whose bit pl is 1
        trades places with the half of shard i ^ 2^(d-1-pg) whose bit pl is
        0."""
        if not (0 <= pg < self.d and self.d + self.w <= pl < self.n):
            raise ValueError(f"swap_global_local({pg}, {pl}): needs a device and a local position")
        gmask = 1 << (self.d - 1 - pg)
        q = pl - self.d - self.w
        for i in range(self.D):
            if i & gmask:
                continue
            for row in self.banks:
                _exchange(_measure._halves(row[i], q, self.m)[:, 1],
                          _measure._halves(row[i | gmask], q, self.m)[:, 0])
        self.dispatch_count += 1
        self._swap_positions(pg, pl)

    def _pick_local_slot(self, avoid: set[int]) -> int:
        # the outermost free local position first: the exchanged halves are
        # then the two contiguous halves of each bank
        for pos in range(self.d + self.w, self.n):
            if pos not in avoid:
                return pos
        raise RuntimeError("no free local position for a qubit swap")

    def localize(self, logical_targets: tuple[int, ...]) -> tuple[int, ...]:
        """Move every target off the device bits (bank bits stay: cross-bank
        ops need no exchange). Returns the physical positions."""
        avoid = {self.perm[q] for q in logical_targets}
        for q in logical_targets:
            p = self.perm[q]
            if p < self.d:
                slot = self._pick_local_slot(avoid)
                self.swap_global_local(p, slot)
                avoid.discard(p)
                avoid.add(slot)
        return tuple(self.perm[q] for q in logical_targets)

    # -- segments: lowering -----------------------------------------------------

    def _segment_key(self, prims) -> bytes:
        """Content key of a segment under the current labelling: each prim's
        matrix, kind and PHYSICAL targets (the only way ``perm`` enters the
        lowering), each field prefixed by its length."""
        h = hashlib.blake2b(digest_size=16)
        for p in prims:
            u = np.ascontiguousarray(p.u)
            h.update(np.asarray(u.shape, np.int16).tobytes())
            h.update(u.tobytes())
            h.update(bytes((1 if p.diag else 0, len(p.targets))))
            h.update(np.asarray([self.perm[q] for q in p.targets], np.int16).tobytes())
        return h.digest()

    def _lowered_segment(self, prims):
        key = self._segment_key(prims)
        steps = self._lowered.get(key)
        if steps is None:
            steps = self._lowered[key] = self._lower_segment(prims)
            if len(self._lowered) > _LOWERED_LRU:
                self._lowered.popitem(last=False)
        else:
            self._lowered.move_to_end(key)
        return steps

    def _lower_segment(self, prims):
        """A run of prims (dense targets already off the device bits) as a
        list of steps: ("banks", plans[i][s]), ("bfly", groups, plans),
        ("crossmix", terms, in_place, groups) and ("gdiag", ops[i][s])."""
        d, w = self.d, self.w
        steps: list = []
        dense_run: list = []

        def flush_dense():
            if not dense_run:
                return
            bank_ops: list = []
            for op in fuse(dense_run, w + self.m, MAX_BLOCK, keep_separate_below=w):
                kind, payload = split_op_virtual(op, w)
                if kind == "per_shard":
                    bank_ops.append(payload)
                    continue
                if bank_ops:
                    steps.append(self._bank_step(bank_ops))
                    bank_ops = []
                if all(t < w for t in payload.targets):
                    steps.append(self._bfly_step(payload))
                else:
                    steps.append(self._crossmix_step(payload))
            if bank_ops:
                steps.append(self._bank_step(bank_ops))
            dense_run.clear()

        for p in prims:
            phys = [self.perm[q] for q in p.targets]
            if p.diag and any(t < d for t in phys):
                flush_dense()
                steps.append(self._gdiag_step(p, phys))
            elif p.diag:
                order = sorted(range(len(phys)), key=lambda j: phys[j])
                dn = np.asarray(p.u, dtype=np.complex128)
                if len(phys) > 1:
                    dn = dn.reshape((2,) * len(phys)).transpose(order).reshape(-1)
                dense_run.append(Prim(dn, tuple(phys[j] - d for j in order), diag=True))
            else:
                if any(t < d for t in phys):
                    raise RuntimeError(f"dense prim on device bits {phys} reached the lowering")
                u, srt = _apply._sort_targets(np.asarray(p.dense(), dtype=np.complex128),
                                              tuple(phys))
                dense_run.append(Prim(u, tuple(t - d for t in srt)))
        flush_dense()
        return steps

    def _bank_step(self, bank_ops):
        """Per-bank fused ops -> plans[i][s], the kernel plans of bank s on
        shard i. Diagonal factors that are all ones (a bank's share of a
        controlled phase whose control bit it has at 0) are dropped."""
        memo: dict = {}

        def planned(op, dev):
            key = (id(op), dev)  # every op stays alive in bank_ops meanwhile
            if key not in memo:
                if isinstance(op, DiagLayer):
                    op = DiagLayer(tuple(f for f in op.factors
                                         if not np.all(np.asarray(f[0]) == 1)))
                    memo[key] = plan(op, self.m, dev) if op.factors else None
                else:
                    memo[key] = plan(op, self.m, dev)
            return memo[key]

        plans = []
        for dev in self.mesh:
            per_bank = []
            for s in range(1 << self.w):
                per_bank.append([pl for pl in (planned(ev[s], dev) for ev in bank_ops)
                                 if pl is not None])
            plans.append(per_bank)
        return ("banks", plans)

    def _bank_bit(self, s: int, t: int) -> int:
        """Bank s's value of bank bit t (0 = the bank index's MSB)."""
        return (s >> (self.w - 1 - t)) & 1

    def _bfly_step(self, op):
        """All targets on bank bits: K6 over each group of banks that agree
        on the other bank bits, members ordered by U's index (targets[0] =
        MSB)."""
        w, k = self.w, len(op.targets)
        bits = [1 << (w - 1 - t) for t in op.targets]  # in the bank index, MSB first
        groups = [tuple(base | sum(b for j, b in enumerate(bits) if (val >> (k - 1 - j)) & 1)
                        for val in range(1 << k))
                  for base in range(1 << w) if not any(base & b for b in bits)]
        plans = {dv: kernels.shard_butterfly_prepare(op.u, dv) for dv in set(self.mesh)}
        return ("bfly", groups, plans)

    def _crossmix_step(self, op):
        """Bank and local targets: per output bank, the terms (s_in, how)
        with how = ("ident",), ("scalar", c) or ("op", {device: plan}) of
        the nonzero blocks. ``in_place`` when each output takes exactly one
        input and the inputs are a permutation of the banks (a
        bank-controlled gate): the terms then update their inputs in place.
        Else the outputs are summed out of place, one group of banks (those
        that agree on the other bank bits) at a time."""
        w, m = self.w, self.m
        rest = tuple(t - w for t in op.targets if t >= w)
        vbits = [t for t in op.targets if t < w]
        h = 1 << len(rest)
        S = 1 << w
        mask = sum(1 << (w - 1 - t) for t in range(w) if t not in vbits)
        eye = np.eye(h)

        def block_index(s):
            return _field(lambda t: self._bank_bit(s, t), vbits)

        def how(blk):
            if not blk.any():
                return None
            if np.allclose(blk, eye, atol=1e-14):
                return ("ident",)
            if not rest:
                return ("scalar", complex(blk[0, 0]))
            return ("op", {dv: plan(DenseOp(blk, rest), m, dv) for dv in set(self.mesh)})

        terms = []
        for s_out in range(S):
            row = []
            for s_in in range(S):
                if (s_out & mask) != (s_in & mask):
                    continue
                bi, bj = block_index(s_out), block_index(s_in)
                hw = how(op.u[bi * h:(bi + 1) * h, bj * h:(bj + 1) * h])
                if hw is not None:
                    row.append((s_in, hw))
            terms.append(tuple(row))
        in_place = (all(len(row) == 1 for row in terms)
                    and sorted(row[0][0] for row in terms) == list(range(S)))
        groups = {}
        for s in range(S):
            groups.setdefault(s & mask, []).append(s)
        return ("crossmix", tuple(terms), in_place, tuple(groups.values()))

    def _gdiag_step(self, p: Prim, phys):
        """A diagonal on device bits: for each shard and bank, the slice of
        its table at that shard's device bits and that bank's bank bits,
        applied as one K2 factor on the local targets, or as a scalar when
        there are none; ops[i][s] is None where the slice is all ones."""
        d, w, m = self.d, self.w, self.m
        order = sorted(range(len(phys)), key=lambda j: phys[j])
        dn = np.asarray(p.u, dtype=np.complex128)
        if len(phys) > 1:
            dn = dn.reshape((2,) * len(phys)).transpose(order).reshape(-1)
        sphys = [phys[j] for j in order]
        outer = [t for t in sphys if t < d + w]
        local = tuple(t - d - w for t in sphys if t >= d + w)
        dk = dn.reshape((2,) * len(sphys))
        ops = []
        for i, dv in enumerate(self.mesh):
            per_bank = []
            for s in range(1 << w):
                row = np.asarray(dk[tuple(self._bit(i, s, t) for t in outer)]).reshape(-1)
                if np.all(row == 1):
                    per_bank.append(None)
                elif not local:
                    per_bank.append(("scalar", complex(row[0])))
                else:
                    per_bank.append(("diag", kernels.diag_prepare(((row, local),), m, dv)))
            ops.append(per_bank)
        return ("gdiag", ops)

    # -- segments: running --------------------------------------------------------

    def _run(self, steps):
        m = self.m
        fns = kernels.KERNEL_FNS
        for step in steps:
            kind = step[0]
            if kind == "banks":
                for i, per_bank in enumerate(step[1]):
                    for s, plans in enumerate(per_bank):
                        for name, args in plans:
                            fns[name][0](self.banks[s][i], *args, m)
            elif kind == "bfly":
                _, groups, plans = step
                for i, dv in enumerate(self.mesh):
                    for members in groups:
                        kernels.shard_butterfly([self.banks[s][i] for s in members], plans[dv], m)
            elif kind == "crossmix":
                self._run_crossmix(*step[1:])
            else:  # gdiag
                for i, per_bank in enumerate(step[1]):
                    for s, op in enumerate(per_bank):
                        if op is None:
                            continue
                        if op[0] == "scalar":
                            self.banks[s][i].mul_(op[1])
                        else:
                            kernels.diag(self.banks[s][i], op[1], m)

    def _apply_term(self, y: torch.Tensor, hw, dev) -> torch.Tensor:
        """Apply one crossmix term's block to bank tensor ``y``, in place."""
        if hw[0] == "scalar":
            y.mul_(hw[1])
        elif hw[0] == "op":
            name, args = hw[1][dev]
            kernels.KERNEL_FNS[name][0](y, *args, self.m)
        return y

    def _run_crossmix(self, terms, in_place: bool, groups):
        S = 1 << self.w
        for i, dv in enumerate(self.mesh):
            col = [self.banks[s][i] for s in range(S)]
            if in_place:
                for s_out, ((s_in, hw),) in enumerate(terms):
                    self.banks[s_out][i] = self._apply_term(col[s_in], hw, dv)
                continue
            for group in groups:
                outs = {}
                for s_out in group:
                    acc = None
                    for s_in, hw in terms[s_out]:
                        t = self._apply_term(col[s_in].clone(), hw, dv)
                        acc = t if acc is None else acc.add_(t)
                        del t
                    outs[s_out] = torch.zeros_like(col[s_out]) if acc is None else acc
                for s_out, t in outs.items():  # the group's inputs are freed here
                    self.banks[s_out][i] = t
                    col[s_out] = None

    # -- applying prims -------------------------------------------------------------

    def apply_fused(self, prims):
        """Apply a prim stream: each run of prims that needs no exchange is
        lowered (once per content, see :meth:`_segment_key`) and run as one
        segment; relabelling swaps come only between segments. Diagonals
        never end a segment."""
        seg: list = []

        def flush():
            if seg:
                self._run(self._lowered_segment(seg))
                self.dispatch_count += 1
                seg.clear()

        for p in prims:
            if not p.diag and any(self.perm[q] < self.d for q in p.targets):
                flush()
                self.localize(tuple(p.targets))
            seg.append(p)
        flush()
        return self

    def apply_prim(self, p: Prim):
        """Apply one prim at LOGICAL targets (one segment)."""
        return self.apply_fused([p])

    def apply(self, prims, fused: bool = True):
        """Apply a prim stream, fused into segments (default) or one segment
        per prim."""
        if fused:
            return self.apply_fused(prims)
        for p in prims:
            self.apply_prim(p)
        return self

    # -- measurement ------------------------------------------------------------------

    def _each(self):
        """(shard i, bank s, tensor) over the whole state."""
        for s, row in enumerate(self.banks):
            for i, t in enumerate(row):
                yield i, s, t

    def prob_one(self, logical_q: int) -> float:
        """Born probability (unnormalized mass) that qubit ``logical_q``
        reads 1, summed in float64 over the banks."""
        p, loc = self.perm[logical_q], self.d + self.w
        if p < loc:
            return sum(_norm2(t) for i, s, t in self._each() if self._bit(i, s, p))
        return sum(_measure.prob_one(t, p - loc, self.m) for _, _, t in self._each())

    def collapse(self, logical_q: int, outcome: int):
        """Project qubit ``logical_q`` onto ``outcome`` and renormalize (a
        zero result stays zero), in place."""
        p, loc, outcome = self.perm[logical_q], self.d + self.w, int(outcome)
        for i, s, t in self._each():
            if p >= loc:
                _measure._halves(t, p - loc, self.m)[:, 1 - outcome].zero_()
            elif self._bit(i, s, p) != outcome:
                t.zero_()
        nrm2 = sum(_norm2(t) for _, _, t in self._each())
        if nrm2 > 0:
            scale = 1.0 / math.sqrt(nrm2)
            for _, _, t in self._each():
                t.mul_(scale)
        return self

    def measure_qubit(self, logical_q: int, gen: torch.Generator | None = None,
                      uniform: float | None = None) -> int:
        """Sample qubit ``logical_q`` (one uniform from ``gen``, or
        ``uniform``) and collapse. Returns the bit."""
        r = _measure.draw(gen, 1)[0] if uniform is None else uniform
        outcome = int(r < _measure._threshold(self.prob_one(logical_q)))
        self.collapse(logical_q, outcome)
        self.dispatch_count += 1
        return outcome

    def measure_qubits(self, logical_qs, gen: torch.Generator | None = None,
                       uniforms=None) -> list[int]:
        """Measure ``logical_qs`` one after another (collapse-as-you-go, one
        uniform each, drawn up front as ``measure.measure_qubits`` draws
        them): up to 16 distinct qubits as one marginal table (per-bank
        tables summed on the host), the ancestral draws and one projection
        of every bank; else qubit by qubit."""
        qs = list(logical_qs)
        u = _measure.draw(gen, len(qs), uniforms)
        if (config.force_sequential_measure or not qs or len(qs) > _measure._MEASURE_TABLE_MAX
                or len(set(qs)) != len(qs)):
            return [self.measure_qubit(q, uniform=u[j]) for j, q in enumerate(qs)]
        d, w, m = self.d, self.w, self.m
        phys = tuple(self.perm[q] for q in qs)
        table = self._table(phys)
        outcomes = _measure.ancestral_draws(table, phys, u)
        got = dict(zip(phys, outcomes))
        mass = table[_field(lambda p: got[p], sorted(phys))]
        scale = 1.0 / math.sqrt(mass) if mass > 0 else 0.0
        local = [p for p in phys if p >= d + w]
        for i, s, t in self._each():
            keep = all(self._bit(i, s, p) == got[p] for p in phys if p < d + w)
            if keep and scale:
                _measure.project(t, m, [p - d - w for p in local], [got[p] for p in local], scale)
            else:
                t.zero_()
        self.dispatch_count += 1
        return outcomes

    def _bit(self, i: int, s: int, p: int) -> int:
        """Shard i's and bank s's value of the device or bank position p."""
        return (i >> (self.d - 1 - p)) & 1 if p < self.d else self._bank_bit(s, p - self.d)

    def _table(self, phys) -> np.ndarray:
        """The Born masses of the physical positions ``phys``: a (2^k,)
        float64 host table whose index bits are sorted(phys), MSB first. The
        device and bank positions come first in that order, so each bank's
        local table fills one contiguous slice."""
        d, w = self.d, self.w
        srt = sorted(phys)
        outer = [p for p in srt if p < d + w]
        local = tuple(p - d - w for p in srt if p >= d + w)
        table = np.zeros(1 << len(srt))
        for i, s, t in self._each():
            off = _field(lambda p: self._bit(i, s, p), outer) << len(local)
            table[off:off + (1 << len(local))] += _measure.marginal_table(t, self.m, local)
        return table

    def marginal(self, logical_qs) -> np.ndarray:
        """The Born masses of ``logical_qs`` ((2^k,) float64; index bit j,
        MSB first, is ``logical_qs[j]``), without a collapse."""
        phys = [self.perm[q] for q in logical_qs]
        k = len(phys)
        order = sorted(range(k), key=lambda j: phys[j])  # table axis a = qubit order[a]
        return (self._table(phys).reshape((2,) * k)
                .transpose([order.index(j) for j in range(k)]).reshape(-1))

    # -- observables -----------------------------------------------------------------

    def _to_phys_pauli(self, pauli: str) -> str:
        """A Pauli string in logical qubit order, uppercased and checked, as
        the string over the physical bit positions."""
        pauli = pauli.upper()
        if len(pauli) != self.n or any(c not in "IXYZ" for c in pauli):
            raise ValueError(
                f"Pauli string must be {self.n} chars of I/X/Y/Z: {pauli!r}")
        phys = ["I"] * self.n
        for q, c in enumerate(pauli):
            phys[self.perm[q]] = c
        return "".join(phys)

    def expectation(self, pauli: str) -> float:
        """Pauli-string expectation (logical qubit order, I/X/Y/Z)."""
        return self.expectation_sum([(1.0, pauli)])

    def expectation_sum(self, terms) -> float:
        """<psi| sum_j c_j P_j |psi> for ``terms = [(coef, pauli), ...]``.
        Terms are grouped by their flip mask; for each group, bank (i, s)
        is paired with the bank whose device and bank bits differ by the
        mask's upper part, and the pair is reduced over the local bits by
        ``measure.pauli_pair_sums``."""
        m, w = self.m, self.w
        # #Y is counted on the uppercased physical string: the relabelling
        # keeps the letters, and a lowercase 'y' must not lose its factor i
        paulis = [self._to_phys_pauli(p) for _, p in terms]
        masks = [_measure.pauli_masks(p) for p in paulis]
        lmask = (1 << m) - 1
        total = 0.0
        for f, idxs in _measure.group_terms(paulis).items():
            zs_loc = [masks[j][1] & lmask for j in idxs]
            zs_out = np.array([masks[j][1] >> m for j in idxs], dtype=np.int64)
            sums = np.zeros(len(idxs), dtype=np.complex128)
            for i, s, a in self._each():
                o = (i << w) | s
                po = o ^ (f >> m)
                b = self.banks[po & ((1 << w) - 1)][po >> w]
                part = _measure.pauli_pair_sums(a, b, m, f & lmask, zs_loc)
                sums += part * _measure._parity_sign(zs_out & o, -1)
            for sm, j in zip(sums, idxs):
                total += terms[j][0] * _measure._apply_iy(sm.real, sm.imag, masks[j][2]).real
        return float(total)

    # -- sampling --------------------------------------------------------------------

    def sample(self, shots: int, gen: torch.Generator | None = None, uniforms=None) -> np.ndarray:
        """Sample basis-state indices in LOGICAL qubit order ((shots,) int64):
        each uniform picks a shard by the shards' masses, a bank by the
        shard's bank masses and an index by the bank's own CDF (float64)."""
        d, w, m = self.d, self.w, self.m
        S = 1 << w
        u = _measure.draw(gen, shots, uniforms)
        cdfs = [[_sample.row_cdf(self.banks[s][i], m) for s in range(S)] for i in range(self.D)]
        bank_cdf = np.cumsum([[float(c[-1]) for c in row] for row in cdfs], axis=1)  # (D, S)
        dev_cdf = np.cumsum(bank_cdf[:, -1])
        uu = u * dev_cdf[-1]
        dev = np.clip(np.searchsorted(dev_cdf, uu, side="right"), 0, self.D - 1)
        resid = uu - np.where(dev > 0, dev_cdf[np.maximum(dev - 1, 0)], 0.0)
        bank = np.zeros(shots, dtype=np.int64)
        for i in range(self.D):
            sel = dev == i
            bank[sel] = np.clip(np.searchsorted(bank_cdf[i], resid[sel], side="right"), 0, S - 1)
        resid -= np.where(bank > 0, bank_cdf[dev, np.maximum(bank - 1, 0)], 0.0)
        loc = np.zeros(shots, dtype=np.int64)
        for i, s, t in self._each():
            sel = (dev == i) & (bank == s)
            if sel.any():
                target = torch.from_numpy(resid[sel]).to(t.device)
                loc[sel] = _sample.search(t, m, target, cdfs[i][s]).cpu().numpy()
        # combined in int64: an int32 index overflows from n = 31
        phys_idx = (dev.astype(np.int64) << (w + m)) | (bank << m) | loc
        return self._to_logical_indices(phys_idx)

    def _to_logical_indices(self, phys_idx: np.ndarray) -> np.ndarray:
        if self.perm == list(range(self.n)):
            return phys_idx.astype(np.int64)
        out = np.zeros_like(phys_idx, dtype=np.int64)
        for logical in range(self.n):
            bit = (phys_idx >> (self.n - 1 - self.perm[logical])) & 1
            out |= bit.astype(np.int64) << (self.n - 1 - logical)
        return out

    # -- host access (tests, small n) -------------------------------------------------

    def amplitudes(self) -> np.ndarray:
        """The state on the host (complex128) in LOGICAL qubit order."""
        z = np.stack([np.stack([_apply.complex_from_state(self.banks[s][i])
                                for s in range(1 << self.w)]) for i in range(self.D)])
        z = z.reshape(-1)  # [shard][bank][local]
        if self.perm == list(range(self.n)):
            return z
        # axis p of the physical tensor holds logical qubit inv[p]
        return z.reshape((2,) * self.n).transpose(self.perm).reshape(-1)
