"""Gate fusion for the interpreter's lazy gate queue.

A run of primitives is lowered into **fused ops**, each applied in one pass
over the state by one kernel of :mod:`.kernels`:

* **Dense blocks** (qsim-style): consecutive primitives whose combined
  target set stays within 4 qubits are multiplied host-side into one
  2^k x 2^k block (the ``gate`` kernel). Unions whose targets all lie in
  the lane block (the last 7 qubits) merge at any size: they apply as one
  expanded lane matrix (the ``lane`` kernel).
* **Diagonal layers**: diagonal blocks commute; consecutive ones merge into
  a :class:`DiagLayer` whose factors multiply the state in one pass (the
  ``diag`` kernel).
* **1q layers**: runs of 4 or more disjoint dense 1q gates on qubits above
  the lane block are cut into :class:`Layer1QOp` chunks of at most
  ``_LAYER1Q_MAX`` gates (the ``layer1q`` kernel).

These are the fusion semantics of qubism_tpu/ops/fusion.py with
``max_block=4, mixed_lane=True``, at every n; what that module sized for
the TPU (its pass-cost model, axis-slot caps and operand caches) is not
carried over. The QFT stage prepass and stage blocks are left out: QASM
input never produces them (the interpreter queues only U and CX).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.gates import Prim, is_diagonal
from . import apply as _apply
from . import kernels

MAX_BLOCK = 4

#: gates per 1q-layer pass (each gate is 2 complex MACs per amplitude; at 6
#: a thread of the layer1q kernel holds 64 amplitudes in registers)
_LAYER1Q_MAX = kernels._LAYER1Q_MAX


@dataclass(frozen=True)
class DenseOp:
    u: np.ndarray  # (2^k, 2^k) complex128, targets sorted ascending
    targets: tuple[int, ...]


@dataclass(frozen=True)
class Layer1QOp:
    """A run of disjoint single-qubit dense gates applied in ONE pass."""

    gates: tuple  # ((u (2,2) complex, q), ...), q ascending, distinct

    @property
    def targets(self):
        return tuple(q for _, q in self.gates)


@dataclass(frozen=True)
class DiagLayer:
    """A product of commuting diagonal factors, applied in one fused pass."""

    factors: tuple[tuple[np.ndarray, tuple[int, ...]], ...]  # (2^k diag, targets)


def _prim_sorted_dense(p: Prim) -> tuple[np.ndarray, tuple[int, ...]]:
    """Primitive as a dense matrix with sorted targets."""
    u = np.asarray(p.dense(), dtype=np.complex128)
    return _apply._sort_targets(u, p.targets)


def _union_ok(union: tuple[int, ...], n: int) -> bool:
    """Fusion admission by region: pure-lane unions merge at any size (one
    lane matrix); row and mixed row+lane unions up to MAX_BLOCK targets."""
    b = max(n - _apply._COL, 0)
    if all(t >= b for t in union):
        return True
    return len(union) <= MAX_BLOCK


def _layer1q_prepass(prims, n: int):
    """Group runs of consecutive dense 1q prims on DISTINCT row qubits into
    Layer1QOp passes of at most _LAYER1Q_MAX gates. Disjoint 1q gates
    commute, so a run may be cut anywhere. Runs shorter than 4 stay prims:
    greedy dense fusion handles those at the same cost and can absorb
    neighboring 2q gates."""
    b_lane = max(n - _apply._COL, 0)
    out: list = []
    run: list = []  # [(u, q)]

    def flush():
        if len(run) < 4:
            out.extend(Prim(u, (q,)) for u, q in run)
        else:
            for i in range(0, len(run), _LAYER1Q_MAX):
                chunk = run[i:i + _LAYER1Q_MAX]
                if len(chunk) == 1:
                    out.append(Prim(chunk[0][0], (chunk[0][1],)))
                else:
                    out.append(Layer1QOp(tuple(sorted(chunk, key=lambda g: g[1]))))
        run.clear()

    for p in prims:
        ok = (not p.diag and len(p.targets) == 1 and p.targets[0] < b_lane)
        if not ok:
            flush()
            out.append(p)
            continue
        q = p.targets[0]
        if any(q == g[1] for g in run):
            flush()
        run.append((np.asarray(p.u, dtype=np.complex128), q))
    flush()
    return out


def fuse(prims, n: int) -> list:
    """Greedy fusion: prims -> [Layer1QOp | DenseOp | DiagLayer]."""
    items = _layer1q_prepass(prims, n)
    blocks: list = []
    cur_u: np.ndarray | None = None
    cur_t: tuple[int, ...] = ()

    def flush():
        nonlocal cur_u, cur_t
        if cur_u is not None:
            blocks.append(DenseOp(cur_u, cur_t))
            cur_u, cur_t = None, ()

    for p in items:
        if isinstance(p, Layer1QOp):
            flush()
            blocks.append(p)
            continue
        u, t = _prim_sorted_dense(p)
        if cur_u is None:
            cur_u, cur_t = u, t
            continue
        union = tuple(sorted(set(cur_t) | set(t)))
        if _union_ok(union, n):
            a = _apply._expand_np(cur_u, cur_t, union)
            b = _apply._expand_np(u, t, union)
            cur_u, cur_t = b @ a, union  # p applies after the block
            continue
        flush()
        cur_u, cur_t = u, t
    flush()

    # merge consecutive diagonal blocks into layers
    out: list = []
    for b in blocks:
        if isinstance(b, DenseOp) and is_diagonal(b.u):
            b = DiagLayer(((np.diag(b.u).copy(), b.targets),))
        if isinstance(b, DiagLayer) and out and isinstance(out[-1], DiagLayer):
            out[-1] = DiagLayer(out[-1].factors + b.factors)
        else:
            out.append(b)
    return out


def plan(op, n: int):
    """The kernel for one fused op and its operands: (name, args) with
    ``getattr(kernels, name)(state, *args, n)`` applying it (and
    ``name + "_plain"`` naming the plain version)."""
    if isinstance(op, DiagLayer):
        return "diag", (op.factors,)
    if isinstance(op, Layer1QOp):
        return "layer1q", (op.gates,)
    b = max(n - _apply._COL, 0)
    if all(t >= b for t in op.targets):
        return "lane", (_apply.expand_for_view(op.u, n, op.targets),)
    if len(op.targets) <= MAX_BLOCK:
        return "gate", (op.u, op.targets)
    raise ValueError(f"no kernel for a dense block on {op.targets} "
                     f"(more than {MAX_BLOCK} targets off the lane block)")


def apply_prims_fused(state, prims, n: int):
    """Apply a run of prims to an n-qubit state in place, one kernel pass
    per fused op. Returns the state."""
    for op in fuse(list(prims), n):
        name, args = plan(op, n)
        getattr(kernels, name)(state, *args, n)
    return state
