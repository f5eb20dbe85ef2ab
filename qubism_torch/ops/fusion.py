"""Gate fusion and the compiled circuit executor.

A run of primitives is lowered into **fused ops**, each applied in one pass
over the state by one kernel of :mod:`.kernels`:

* **Stage blocks**: a dense 1q gate on a row qubit q followed by a ladder
  of 2q diagonals (q, j), j > q, whose q = 0 branch is the identity (the
  QFT stage) is a :class:`StageOp`; runs of stages on adjacent qubits are
  grouped into :class:`StageBlockOp` passes of up to ``stage_group``
  stages (the ``stage`` kernel). QASM input hardly produces them (the
  interpreter and the compiler queue only U and CX, qelib1's ``cu1``
  expands to those, and the diagonal that :func:`diagonal_runs` makes of
  one carries rounding in its identity branch); prim streams with real
  2q diagonal prims do
  (``models.circuits.qft_prims``, the DSL's ``controlled(i, phase(l))``).
* **Dense blocks** (qsim-style): consecutive primitives whose combined
  target set stays within ``max_block`` (<= 4) qubits are multiplied
  host-side into one 2^k x 2^k block (the ``gate`` kernel). Unions whose
  targets all lie in the lane block (the last 7 qubits) merge at any size:
  they apply as one expanded lane matrix (the ``lane`` kernel).
* **Diagonal layers**: diagonal blocks commute; consecutive ones merge into
  a :class:`DiagLayer` whose factors multiply the state in one pass (the
  ``diag`` kernel). A diagonal prim on more than 4 targets (a Grover
  oracle) becomes a factor as it is, never a dense matrix.
* **1q layers**: runs of 4 or more disjoint dense 1q gates on qubits above
  the lane block are cut into :class:`Layer1QOp` chunks of at most
  ``_LAYER1Q_MAX`` gates (the ``layer1q`` kernel).
* **Bit permutations**: a dense block whose matrix only moves qubit values
  between its targets (exactly one entry, exactly 1, in each column, as a
  permutation of the targets' bits sends it; a swap, whether a SWAP prim or
  qelib1's three cx) is a bit permutation. Runs of two or more consecutive
  ones merge into one :class:`PermuteOp` over all n qubits, of any width,
  while their composition stays an involution (the ``permute`` kernel, one
  pass in place). A lone one stays a dense block, and a run that composes
  to the identity is dropped.

These are the fusion semantics of qubism_tpu/ops/fusion.py on its kernel
path (``max_block <= 4``, ``mixed_lane=True``), at every n, but for the
bit permutations, which that module leaves as greedy dense blocks of up to
4 qubits (the QFT's 15 final swaps at n = 30 are 8 passes there, one
here); what that module sized for the TPU (its pass-cost model, axis-slot
caps, virtual shards, chunked jits and operand caches) is not carried over.
``keep_separate_below`` and :func:`split_op_virtual`, which the JAX package
shares between its virtual shards and the mesh's banks, serve the mesh's
banks here (:mod:`qubism_torch.parallel.sharded`).

**The QASM routes depart further** (:func:`fuse_scheduled`: the
interpreter's flushes and ``--compile``'s segments; :func:`fuse`, the DSL,
the models and the mesh keep the greedy order above). Greedy fusion in
program order folds qelib1's cz (h, cx, h) with the gates beside it into
dense 4-qubit blocks, so a random circuit's CZ layer never becomes a
diagonal pass nor its 1-qubit layer a ``layer1q`` pass. So a flush is also
planned reordered: each run of consecutive prims on at most 2 qubits whose
product is diagonal becomes one diagonal prim (:func:`diagonal_runs`: the
same product), then the prims are placed in as-soon-as-possible layers in
which only commuting prims change places (:func:`layered`: diagonals
commute with each other, prims on disjoint qubits commute). That plan is
kept where it costs fewer passes than the greedy plan of the flush as it
came, a lane pass counting ``LANE_PASS_COST`` gate passes, both counted from
targets alone (:func:`_pass_cost`); else the greedy plan is, op for op as
:func:`fuse` makes it. The reordered plan can break what program order
gives: a QFT text's cu1 ladders and its swaps' one :class:`PermuteOp`.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

import numpy as np
import torch

from ..core.gates import Prim, is_diagonal
from ..utils import profiling
from . import apply as _apply
from . import kernels

#: the widest dense block a kernel applies off the lane block
MAX_BLOCK = 4
DEFAULT_MAX_BLOCK = 5

#: stages per stage-block pass. A pass costs the same at k = 2 and k = 4
#: (memory-bound), so 4 halves the QFT's stage passes: QFT-28 took 20.8
#: device ms at 4 against 28.5 at 2 on an H100 80GB HBM3 at 700 W
#: (chip_smoke.py prints both; PERF.md)
STAGE_GROUP = 4

#: gates per 1q-layer pass (each gate is 2 complex MACs per amplitude; at 6
#: a thread of the layer1q kernel holds 64 amplitudes in registers)
_LAYER1Q_MAX = kernels._LAYER1Q_MAX


@dataclass(frozen=True)
class DenseOp:
    u: np.ndarray  # (2^k, 2^k) complex128, targets sorted ascending
    targets: tuple[int, ...]


@dataclass(frozen=True)
class StageOp:
    """A dense 1q gate on row qubit q fused with a controlled-phase ladder
    sharing q (the QFT stage shape)."""

    u: np.ndarray    # (2, 2) complex
    q: int
    factors: tuple   # ((d (4,), (q, j)), ...) with j > q, d[0] = d[1] = 1

    @property
    def targets(self):
        return (self.q,)


@dataclass(frozen=True)
class StageBlockOp:
    """Up to four consecutive stages on adjacent qubits, applied in ONE pass
    (kernels.stage_block_prepare folds them)."""

    stages: tuple  # ((u (2,2), q, factors), ...), q strictly ascending

    @property
    def targets(self):
        return tuple(q for _, q, _ in self.stages)


@dataclass(frozen=True)
class Layer1QOp:
    """A run of disjoint single-qubit dense gates applied in ONE pass."""

    gates: tuple  # ((u (2,2) complex, q), ...), q ascending, distinct

    @property
    def targets(self):
        return tuple(q for _, q in self.gates)


@dataclass(frozen=True)
class PermuteOp:
    """A run of bit permutations applied in ONE pass: the value of qubit q
    moves to qubit perm[q], an involution over all n qubits."""

    perm: tuple[int, ...]

    @property
    def targets(self):
        return tuple(q for q, p in enumerate(self.perm) if p != q)


@dataclass(frozen=True)
class DiagLayer:
    """A product of commuting diagonal factors, applied in one fused pass."""

    factors: tuple[tuple[np.ndarray, tuple[int, ...]], ...]  # (2^k diag, targets)


def _prim_sorted_dense(p: Prim) -> tuple[np.ndarray, tuple[int, ...]]:
    """Primitive as a dense matrix with sorted targets."""
    u = np.asarray(p.dense(), dtype=np.complex128)
    return _apply._sort_targets(u, p.targets)


def _prim_sorted_diag(p: Prim) -> DiagLayer:
    """A diagonal primitive as a one-factor layer with sorted targets."""
    d = np.asarray(p.u, dtype=np.complex128)
    order = tuple(sorted(range(len(p.targets)), key=lambda i: p.targets[i]))
    if order != tuple(range(len(p.targets))):
        d = d.reshape((2,) * len(p.targets)).transpose(order).reshape(-1)
    return DiagLayer(((d, tuple(sorted(p.targets))),))


def _union_ok(union: tuple[int, ...], n: int, max_block: int,
              keep_separate_below: int = 0) -> bool:
    """Fusion admission by region: pure-lane unions merge at any size (one
    lane matrix); row and mixed row+lane unions up to ``max_block``
    targets. A union of two or more targets that touches a qubit below
    ``keep_separate_below`` (a bank bit of the mesh path) never merges."""
    if len(union) > 1 and any(t < keep_separate_below for t in union):
        return False
    b = max(n - _apply._COL, 0)
    if all(t >= b for t in union):
        return True
    return len(union) <= max_block


def _stage_prepass(prims, n: int, keep_separate_below: int = 0):
    """Detect [1q dense on row qubit q] + [run of 2q diagonals (q, j), j > q,
    with an identity q = 0 branch] and fuse each into a StageOp. No stage
    starts on a qubit below ``keep_separate_below``."""
    b_lane = max(n - _apply._COL, 0)
    out: list = []
    prims = list(prims)
    i = 0
    while i < len(prims):
        p = prims[i]
        if (not p.diag and len(p.targets) == 1
                and keep_separate_below <= p.targets[0] < b_lane):
            q = p.targets[0]
            ladder = []
            j = i + 1
            while j < len(prims):
                nxt = prims[j]
                if not (nxt.diag and len(nxt.targets) == 2 and q in nxt.targets):
                    break
                other = nxt.targets[0] if nxt.targets[1] == q else nxt.targets[1]
                if other <= q:
                    break
                d = np.asarray(nxt.u, dtype=np.complex128)
                if nxt.targets[0] == other:  # stored (other, q): permute to (q, other)
                    d = d.reshape(2, 2).T.reshape(-1)
                if not (d[0] == 1 and d[1] == 1):
                    break
                ladder.append((d, (q, other)))
                j += 1
            if ladder:
                out.append(StageOp(np.asarray(p.u, dtype=np.complex128), q, tuple(ladder)))
                i = j
                continue
        out.append(p)
        i += 1
    return out


def _layer1q_prepass(items, n: int, keep_separate_below: int = 0):
    """Group runs of consecutive dense 1q prims on DISTINCT row qubits into
    Layer1QOp passes of at most _LAYER1Q_MAX gates. Disjoint 1q gates
    commute, so a run may be cut anywhere. Runs shorter than 4 stay prims:
    greedy dense fusion handles those at the same cost and can absorb
    neighboring 2q gates. StageOps, and gates on qubits below
    ``keep_separate_below``, break runs and pass through."""
    b_lane = max(n - _apply._COL, 0)
    out: list = []
    run: list = []  # [Prim]

    def flush():
        if len(run) < 4:
            out.extend(run)
        else:
            for i in range(0, len(run), _LAYER1Q_MAX):
                chunk = run[i:i + _LAYER1Q_MAX]
                if len(chunk) == 1:
                    out.append(chunk[0])
                else:
                    gates = ((np.asarray(p.u, dtype=np.complex128), p.targets[0]) for p in chunk)
                    out.append(Layer1QOp(tuple(sorted(gates, key=lambda g: g[1]))))
        run.clear()

    for p in items:
        ok = (isinstance(p, Prim) and not p.diag and len(p.targets) == 1
              and keep_separate_below <= p.targets[0] < b_lane)
        if not ok:
            flush()
            out.append(p)
            continue
        if any(p.targets == g.targets for g in run):
            flush()
        run.append(p)
    flush()
    return out


def fuse(prims, n: int, max_block: int = DEFAULT_MAX_BLOCK,
         stage_group: int | None = None, keep_separate_below: int = 0) -> list:
    """Greedy fusion: prims -> [StageBlockOp | Layer1QOp | DenseOp |
    DiagLayer | PermuteOp]. ``max_block`` is clamped to 4, the widest dense
    block the gate kernel takes; ``stage_group`` (1..4) caps the stages per
    block.
    A prim that touches a qubit below ``keep_separate_below`` (the bank bits
    of the mesh path, which :func:`split_op_virtual` splits off) merges with
    no other prim, though diagonals still join a diagonal layer, and joins
    no PermuteOp."""
    stage_group = STAGE_GROUP if stage_group is None else stage_group
    if not 1 <= stage_group <= 4:
        raise ValueError(f"stage_group {stage_group}: 1..4 supported")
    with profiling.span("qubism.fuse"):
        return _lower(_blocks(prims, n, max_block, keep_separate_below), n, stage_group,
                      keep_separate_below)


@dataclass(frozen=True)
class _Block:
    """A run of prims that greedy fusion multiplies into one dense block."""

    prims: tuple
    targets: tuple[int, ...]  # their union, sorted


def _blocks(prims, n: int, max_block: int, keep_separate_below: int) -> list:
    """Greedy fusion's plan, from targets alone: the prepasses' StageOps and
    Layer1QOps, wide diagonal prims (each a factor as it is) and _Blocks.
    Nothing is multiplied yet."""
    max_block = min(max_block, MAX_BLOCK)
    items = _layer1q_prepass(_stage_prepass(prims, n, keep_separate_below), n,
                             keep_separate_below)
    out: list = []
    run: list = []
    cur_t: tuple[int, ...] = ()
    for p in items:
        if isinstance(p, (StageOp, Layer1QOp)) or (p.diag and len(p.targets) > 4):
            # a wide diagonal (a whole-register Grover oracle) goes straight
            # to a factor: densifying it would build a 2^k x 2^k matrix
            if run:
                out.append(_Block(tuple(run), cur_t))
                run = []
            out.append(p)
            continue
        t = tuple(sorted(p.targets))
        if run:
            union = tuple(sorted(set(cur_t) | set(t)))
            if _union_ok(union, n, max_block, keep_separate_below):
                run.append(p)
                cur_t = union
                continue
            out.append(_Block(tuple(run), cur_t))
        run, cur_t = [p], t
    if run:
        out.append(_Block(tuple(run), cur_t))
    return out


def _product(prims) -> DenseOp:
    """The dense block of a run of prims, multiplied in program order."""
    cur_u, cur_t = _prim_sorted_dense(prims[0])
    for p in prims[1:]:
        u, t = _prim_sorted_dense(p)
        union = tuple(sorted(set(cur_t) | set(t)))
        a = _apply._expand_np(cur_u, cur_t, union)
        b = _apply._expand_np(u, t, union)
        cur_u, cur_t = b @ a, union  # p applies after the block
    return DenseOp(cur_u, cur_t)


def _lower(blocks: list, n: int, stage_group: int, keep_separate_below: int) -> list:
    """A plan of :func:`_blocks` as fused ops: each _Block multiplied out,
    diagonal blocks merged into layers, stages grouped, runs of bit
    permutations merged."""
    out: list = []
    for b in blocks:
        if isinstance(b, _Block):
            b = _product(b.prims)
            if is_diagonal(b.u):
                b = DiagLayer(((np.diag(b.u).copy(), b.targets),))
        elif isinstance(b, Prim):
            b = _prim_sorted_diag(b)
        if isinstance(b, DiagLayer) and out and isinstance(out[-1], DiagLayer):
            out[-1] = DiagLayer(out[-1].factors + b.factors)
        else:
            out.append(b)

    # group runs of consecutive stages on adjacent qubits into blocks of up
    # to ``stage_group`` (a k-block cuts the QFT's pass count by k)
    grouped: list = []
    i = 0
    while i < len(out):
        a = out[i]
        if not isinstance(a, StageOp):
            grouped.append(a)
            i += 1
            continue
        grp = [a]
        while len(grp) < stage_group and i + len(grp) < len(out):
            b = out[i + len(grp)]
            if not (isinstance(b, StageOp) and b.q == grp[-1].q + 1):
                break
            grp.append(b)
        grouped.append(StageBlockOp(tuple((s.u, s.q, s.factors) for s in grp)))
        i += len(grp)
    return _permute_runs(grouped, n, keep_separate_below)


def _qubit_map(op, n: int, keep_separate_below: int):
    """The qubit map of a dense block on qubits at or above
    ``keep_separate_below`` that only moves qubit values between its
    targets (the value of qubit q moves to qubit map[q]), else None."""
    if not isinstance(op, DenseOp) or op.targets[0] < keep_separate_below:
        return None
    u, k = op.u, len(op.targets)
    dim = 1 << k
    if np.count_nonzero(u) != dim:
        return None
    cols = np.arange(dim)
    rows = np.argmax(u != 0, axis=0)  # each column's first nonzero entry
    if not np.all(u[rows, cols] == 1):
        return None
    # target j is bit k-1-j of u's index; where does it go?
    dest = []
    for j in range(k):
        r = int(rows[1 << (k - 1 - j)])
        if r & (r - 1) or r == 0:
            return None
        dest.append(k - r.bit_length())
    if sorted(dest) != list(range(k)):
        return None
    image = np.zeros(dim, dtype=np.int64)
    for j, m in enumerate(dest):
        image |= ((cols >> (k - 1 - j)) & 1) << (k - 1 - m)
    if not np.array_equal(rows, image):
        return None
    qmap = list(range(n))
    for j, m in enumerate(dest):
        qmap[op.targets[j]] = op.targets[m]
    return tuple(qmap)


def _permute_runs(ops: list, n: int, keep_separate_below: int) -> list:
    """Merge runs of two or more consecutive bit-permutation blocks into
    one PermuteOp. A run ends before the block whose composition with it is
    not an involution (the kernel's pairing needs one); that block starts
    the next run. A lone block stays as it is; a run that composes to the
    identity is dropped."""
    out: list = []
    run: list = []
    comp: tuple = ()

    def close():
        if len(run) == 1:
            out.append(run[0])
        elif run and any(p != q for q, p in enumerate(comp)):
            out.append(PermuteOp(comp))
        run.clear()

    for op in ops:
        qmap = _qubit_map(op, n, keep_separate_below)
        if qmap is None:
            close()
            out.append(op)
            continue
        nxt = tuple(qmap[c] for c in comp) if run else qmap  # the block after the run
        if run and any(nxt[p] != q for q, p in enumerate(nxt)):
            close()
            nxt = qmap
        run.append(op)
        comp = nxt
    close()
    return out


#: a lane pass's cost in gate passes when :func:`fuse_scheduled` weighs two
#: plans: at n = 30 a lane pass took 10.8 ms and a 4-qubit gate pass 6.0 ms
#: on an H100 80GB HBM3 at 700 W
LANE_PASS_COST = 1.8

#: a 2-qubit index with its two bits swapped: a matrix on (a, b) read on (b, a)
_SWAP_BITS = np.array([0, 2, 1, 3])
#: a 1-qubit diagonal spread over a 2-qubit index, on its high or low bit
_HIGH_BIT = np.array([0, 0, 1, 1])
_LOW_BIT = np.array([0, 1, 0, 1])
_OFF_DIAGONAL = ~np.eye(4, dtype=bool)
_EYE4 = np.eye(4, dtype=np.complex128)


def fuse_scheduled(prims, n: int, max_block: int = DEFAULT_MAX_BLOCK) -> list:
    """Fusion of a QASM route's flush: the greedy plan of :func:`fuse`, or
    that of the prims after :func:`diagonal_runs` reordered by
    :func:`layered`, whichever :func:`_pass_cost` finds cheaper (the greedy
    plan on a tie). Only the plan kept is multiplied out. Counts one of
    ``sched_greedy`` / ``sched_layered``, and with the latter its
    ``diag_runs`` (``utils.profiling.counters``)."""
    with profiling.span("qubism.fuse"):
        prims = list(prims)
        diagonal, runs = diagonal_runs(prims)
        plans = (_blocks(prims, n, max_block, 0),
                 _blocks(layered(diagonal, n), n, max_block, 0))
        whole = {id(p): {id(q) for q in run} for run in runs for p in run}
        layer = _pass_cost(plans[1], n) < _pass_cost(plans[0], n, whole)
        if layer:
            profiling.count("sched_layered")
            if runs:
                profiling.count("diag_runs", len(runs))
        else:
            profiling.count("sched_greedy")
        return _lower(plans[layer], n, STAGE_GROUP, 0)


def diagonal_runs(prims) -> tuple[list, list]:
    """Each run of consecutive prims on at most 2 qubits whose product is
    diagonal (``core.gates.is_diagonal``'s 1e-12) as one diagonal prim
    carrying that product: qelib1's cz (h, cx, h) and cu1 (u1, cx, u1, cx,
    u1). At each position the longest such run is taken, else the prim
    stays as it is. A run starts at a prim that is not diagonal: a run
    that starts at a diagonal prim is that prim and a run found at the next
    one. Returns (prims, the runs: each a tuple of the prims it took)."""
    prims = list(prims)
    out: list = []
    runs: list = []
    i = 0
    while i < len(prims):
        p = prims[i]
        if p.diag or len(p.targets) > 2:
            out.append(p)
            i += 1
            continue
        pair = list(p.targets)
        prod = _times(_EYE4, p, pair)
        found = None
        diag = False
        for j in range(i + 1, len(prims)):
            q = prims[j]
            new = [t for t in q.targets if t not in pair]
            if len(pair) + len(new) > 2:
                break
            pair += new
            prod = _times(prod, q, pair)
            # a diagonal prim leaves a product that is not diagonal so
            diag = (diag or not q.diag) and np.abs(prod[_OFF_DIAGONAL]).max() <= 1e-12
            if diag:
                found = j + 1, tuple(pair), prod
        if found is None:
            out.append(p)
            i += 1
            continue
        end, targets, prod = found
        d = np.diag(prod)
        # a run on one qubit is that qubit's gate tensored with the identity
        out.append(Prim(d[::2].copy() if len(targets) == 1 else d.copy(), targets, True))
        runs.append(tuple(prims[i:end]))
        i = end
    return out, runs


def _times(m: np.ndarray, p: Prim, pair: list) -> np.ndarray:
    """p applied after m, a 4x4 product on the qubits ``pair`` (pair[0] the
    high bit of its index, pair[1] the low one, or a qubit not named yet)."""
    t, u = p.targets, p.u
    if len(t) == 1:
        high = t[0] == pair[0]
        if p.diag:
            return u[_HIGH_BIT if high else _LOW_BIT][:, None] * m
        if high:
            return (u @ m.reshape(2, 8)).reshape(4, 4)
        return (u @ m.reshape(2, 2, 4)).reshape(4, 4)
    if t[0] != pair[0]:
        u = u[_SWAP_BITS] if p.diag else u[_SWAP_BITS][:, _SWAP_BITS]
    return u[:, None] * m if p.diag else u @ m


def layered(prims, n: int) -> list:
    """The prims in as-soon-as-possible layers under commutation: a diagonal
    prim joins the first diagonal layer after the last non-diagonal prim
    on any of its qubits (diagonals commute with each other), any other
    prim the first non-diagonal layer after every earlier prim on its
    qubits; a layer opens at the end where none is found. Only commuting
    prims change places, so the product is the same. A non-diagonal
    layer's row 1-qubit gates come first, by qubit (Layer1QOp chunks),
    then its other gates, those in the lane block last (one lane block)."""
    b_lane = max(n - _apply._COL, 0)
    layers: list[list] = []
    starts = ([], [])  # the indices of the non-diagonal and the diagonal layers
    last_any: dict[int, int] = {}
    last_dense: dict[int, int] = {}
    for p in prims:
        seen = last_dense if p.diag else last_any
        after = max((seen.get(q, -1) for q in p.targets), default=-1)
        same = starts[p.diag]
        k = bisect.bisect_right(same, after)
        if k == len(same):
            same.append(len(layers))
            layers.append([])
        at = same[k]
        layers[at].append(p)
        for q in p.targets:
            last_any[q] = max(last_any.get(q, -1), at)
            if not p.diag:
                last_dense[q] = at

    def order(p):
        t = p.targets
        if all(q >= b_lane for q in t):
            return 2, min(t)
        return (0 if len(t) == 1 else 1), min(t)

    out: list = []
    for layer in layers:
        out += layer if layer[0].diag else sorted(layer, key=order)
    return out


def _pass_cost(blocks: list, n: int, whole: dict | None = None) -> float:
    """The passes :func:`_lower` makes of a plan of :func:`_blocks`, from
    targets alone, a lane pass weighing LANE_PASS_COST. A _Block is taken
    as diagonal where each of its prims is diagonal or in a diagonal run
    that the block holds whole (``whole``: id of a prim -> the ids of its
    run's prims). Runs of bit permutations are not seen."""
    whole = whole or {}
    b_lane = max(n - _apply._COL, 0)
    cost = 0.0
    prev_diag = False
    stage_q = stages = 0  # the open stage group's last qubit and its size
    for b in blocks:
        diag = isinstance(b, Prim)
        if isinstance(b, _Block):
            ids = {id(p) for p in b.prims}
            diag = all(p.diag or (id(p) in whole and whole[id(p)] <= ids) for p in b.prims)
        if diag:
            cost += not prev_diag  # consecutive diagonals are one layer
            prev_diag, stages = True, 0
            continue
        prev_diag = False
        if isinstance(b, StageOp):
            if 0 < stages < STAGE_GROUP and b.q == stage_q + 1:
                stages += 1
            else:
                cost, stages = cost + 1, 1
            stage_q = b.q
            continue
        stages = 0
        cost += LANE_PASS_COST if isinstance(b, _Block) and b.targets[0] >= b_lane else 1
    return cost


def split_op_virtual(op, v: int):
    """Specialize one fused op on v + m qubits, whose first v qubits are
    bank bits, for each of the 2^v banks. Returns ("per_shard", [op for
    bank s, on the m local qubits]) or, for a dense op on a bank bit,
    ("cross", op) for the caller's cross-bank plans. A diagonal factor on
    bank bits is fixed to each bank's values of those bits."""
    if isinstance(op, StageBlockOp):
        # fuse(keep_separate_below=v) starts no stage on a bank bit, and
        # every ladder bit lies above its stage's qubit
        shifted = StageBlockOp(tuple(
            (u, q - v, tuple((d, (t[0] - v, t[1] - v)) for d, t in factors))
            for u, q, factors in op.stages))
        return ("per_shard", [shifted] * (1 << v))
    if isinstance(op, Layer1QOp):
        shifted = Layer1QOp(tuple((u, q - v) for u, q in op.gates))
        return ("per_shard", [shifted] * (1 << v))
    if isinstance(op, PermuteOp):
        # fuse(keep_separate_below=v) moves no bank bit
        if any(op.perm[q] != q for q in range(v)):
            raise ValueError(f"a permutation of bank bits {op.targets}: no per-bank op")
        return ("per_shard", [PermuteOp(tuple(p - v for p in op.perm[v:]))] * (1 << v))
    if isinstance(op, DiagLayer):
        per = []
        for s in range(1 << v):
            facs = []
            for d, targets in op.factors:
                if any(t < v for t in targets):
                    idx = tuple(((s >> (v - 1 - t)) & 1) if t < v else slice(None)
                                for t in targets)
                    d = np.asarray(d).reshape((2,) * len(targets))[idx].reshape(-1)
                facs.append((d, tuple(t - v for t in targets if t >= v)))
            per.append(DiagLayer(tuple(facs)))
        return ("per_shard", per)
    if all(t >= v for t in op.targets):
        return ("per_shard", [DenseOp(op.u, tuple(t - v for t in op.targets))] * (1 << v))
    return ("cross", op)


def plan(op, n: int, device="cpu"):
    """The kernel for one fused op and its operands: (name, args) with
    ``kernels.KERNEL_FNS[name]`` = (wrapper, plain version), each applying
    the op as ``fn(state, *args, n)``. The operands the kernel reads from
    device memory are uploaded to ``device`` here, once."""
    with profiling.span("qubism.plan"):
        if isinstance(op, StageBlockOp):
            return "stage", (kernels.stage_block_prepare(op.stages, n, device),)
        if isinstance(op, DiagLayer):
            return "diag", (kernels.diag_prepare(op.factors, n, device),)
        if isinstance(op, Layer1QOp):
            return "layer1q", (op.gates,)
        if isinstance(op, PermuteOp):
            return "permute", (kernels.permute_prepare(op.perm, n),)
        b = max(n - _apply._COL, 0)
        if all(t >= b for t in op.targets):
            return "lane", (kernels.lane_prepare(
                _apply.expand_for_view(op.u, n, op.targets), n, device),)
        if len(op.targets) <= MAX_BLOCK:
            return "gate", (op.u, op.targets)
        raise ValueError(f"no kernel for a dense block on {op.targets} "
                         f"(more than {MAX_BLOCK} targets off the lane block)")


def apply_prims_fused(state, prims, n: int):
    """Apply an interpreter flush's prims to an n-qubit state in place, one
    kernel pass per op of :func:`fuse_scheduled`; counts the prims under
    ``prims`` and the fused ops under ``fused_ops``
    (``utils.profiling.counters``). Returns the state."""
    prims = list(prims)
    ops = fuse_scheduled(prims, n, MAX_BLOCK)
    profiling.count("prims", len(prims))
    profiling.count("fused_ops", len(ops))
    for op in ops:
        name, args = plan(op, n, state.device)
        kernels.KERNEL_FNS[name][0](state, *args, n)
    return state


class CompiledCircuit:
    """A measurement-free circuit segment, fused and planned once.

    Construction fuses the prims and prepares every op's kernel operands on
    ``config.device``: the folded stage blocks and their phase tables, the
    diag passes' tables and the lane matrices are uploaded then. A call
    only launches kernels, updating the state tensor in place (one state
    vector of device memory).

    ``optimize=False`` gives one op per prim (a dense block or a one-factor
    diagonal layer); ``scheduled=True`` fuses by :func:`fuse_scheduled`, as
    the QASM routes do. A dense prim on more than 4 targets that leaves the
    lane block has no kernel: construction raises ValueError.
    """

    def __init__(self, n: int, prims, max_block: int = DEFAULT_MAX_BLOCK,
                 optimize: bool = True, stage_group: int | None = None,
                 scheduled: bool = False):
        self.n = n
        self.prims = tuple(prims)
        self.device = _apply.device()
        if scheduled:
            self.ops = fuse_scheduled(self.prims, n, max_block)
        elif optimize:
            self.ops = fuse(self.prims, n, max_block, stage_group)
        else:
            self.ops = [_prim_sorted_diag(p) if p.diag else DenseOp(*_prim_sorted_dense(p))
                        for p in self.prims]
        self._plans = [plan(op, n, self.device) for op in self.ops]

    @property
    def num_passes(self) -> int:
        return len(self.ops)

    def stats(self) -> dict:
        """Fusion statistics, with the keys of the JAX package's."""
        dense = [op for op in self.ops if isinstance(op, DenseOp)]
        layers = [op for op in self.ops if isinstance(op, DiagLayer)]
        blocks = [op for op in self.ops if isinstance(op, StageBlockOp)]
        layers1q = [op for op in self.ops if isinstance(op, Layer1QOp)]
        return {
            "layer1q_passes": len(layers1q),
            "layer1q_gates": sum(len(l.gates) for l in layers1q),
            "n": self.n,
            "prims": len(self.prims),
            "fused_ops": len(self.ops),
            "dense_blocks": len(dense),
            "diag_layers": len(layers),
            "diag_factors": sum(len(l.factors) for l in layers),
            "fused_stage_blocks": len(blocks),
            "fused_stages": sum(len(b.stages) for b in blocks),
            "max_stage_group": max((len(b.stages) for b in blocks), default=0),
            "max_block_qubits": max((len(op.targets) for op in dense), default=0),
            "backend": "cuda" if self.device.type == "cuda" else "plain",
            "virtual_shards": 0,
        }

    def init_state(self) -> torch.Tensor:
        """|0...0> on the circuit's device."""
        return _apply.zero_state(self.n)

    def state_to_complex(self, state: torch.Tensor) -> np.ndarray:
        """Host numpy complex128 amplitudes."""
        return _apply.complex_from_state(state)

    def __call__(self, state: torch.Tensor) -> torch.Tensor:
        if state.device != self.device:
            raise ValueError(f"circuit planned on {self.device}, state on {state.device}")
        for name, args in self._plans:
            kernels.KERNEL_FNS[name][0](state, *args, self.n)
        return state
