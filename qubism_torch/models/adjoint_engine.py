"""The kernel adjoint engine: the adjoint sweep of
:func:`qubism_torch.models.variational.adjoint_value_and_grad_fn` through
the CUDA kernels, the gradient path at the sizes where a state is
gigabytes.

Counterpart of qubism_tpu/models/adjoint_engine.py. The ansatz is cut into
commuting units (:func:`plan_units`), and each unit is applied to the state
in place, forward and then as its dagger, by the kernel wrappers of
:mod:`qubism_torch.ops.kernels`:

* a run of disjoint 1q ops -> ``kernels.layer1q`` for the qubits above the
  lane block, up to ``_LAYER1Q_MAX`` = 6 gates a pass (K4), and one 128 x
  128 kron of the lane-block qubits' gates through ``kernels.lane`` (K3);
* a run of diagonal ops (the rz/rzz/cphase/crz cost layers of QAOA and
  HVA) -> one ``kernels.diag`` call (K2, one pass per 64 factors);
* a fixed dense prim (a CNOT of the HEA ring) -> K1 or K3, as
  :func:`ops.fusion.plan` picks.

Operands are built on the host from theta's values on every call and
reach the card in the kernel parameters (K1, K4, a one-factor K2 pass) or
as a small upload (K3's split matrix, K2's tables and descriptors); theta
stays on the host, so no value is read back from the card per gate. The gradient of a unit comes from the (phi,
lam) pair at the unit's boundary: every op of a unit commutes with the
others and with their generators, so each parameter's ``2 s Im <lam|G
phi>`` needs no un-apply inside the unit; a unit's generator terms are
grouped by flip mask and each group is one :func:`ops.measure.pauli_pair_sums`
walk of the two states (on a card, one pass of the pair kernel), whose
float64 sums are added into one buffer on the device and read back once a
call; the walks and the buffer's slots are planned once per engine
(:func:`contraction_plan`).

What the JAX engine carries for the TPU is not ported: traced diag tables
on the canonical (R, 2048) layout, the straddle-term and axis-slot caps,
and the ``lax.scan`` / ``optimization_barrier`` compile workarounds of its
pair reductions. ``units_per_chunk`` (its jit chunking) is accepted and
changes nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.gates import Prim
from ..ops import apply as A
from ..ops import kernels
from ..ops import measure as M
from ..ops.fusion import MAX_BLOCK, DenseOp, DiagLayer, plan
from ..utils import profiling
from .variational import _GEN, _KIND, PGate, _check_terms, _gen_terms, _host_theta, _op_matrix

# ---------------------------------------------------------------------------
# Unit planning
# ---------------------------------------------------------------------------


def _op_class(op, n: int):
    b = max(n - A._COL, 0)
    if isinstance(op, Prim):
        if op.diag:
            return "diag"
        if len(op.targets) == 1:
            return "1q"
        # a dense prim needs K1 (<= 4 targets) or K3 (all in the lane block)
        if len(op.targets) <= MAX_BLOCK or min(op.targets) >= b:
            return "prim"
        return None
    # PGate: the gradient contraction needs the Pauli-generator identity,
    # so multi-parameter builders (u3: dense derivative only) have no lowering
    if op.name not in _GEN or len(op.pidx) != 1:
        return None
    if _KIND[op.name] == "diag":
        return "diag"
    return "1q" if len(op.targets) == 1 else None


def plan_units(ops, n: int):
    """Group an op stream into commuting kernel units ``(kind, [ops])``:
    maximal runs of diagonal ops ("diag"), maximal runs of target-disjoint
    1q ops ("1q"), and single fixed dense prims ("prim"). Returns None when
    some op has no kernel lowering (a parameterized dense gate on >= 2
    qubits, a multi-parameter gate, or a dense prim on more than 4 qubits
    that leaves the lane block)."""
    units: list[tuple[str, list]] = []
    for op in ops:
        cls = _op_class(op, n)
        if cls is None:
            return None
        if cls == "prim":
            units.append(("prim", [op]))
            continue
        if (units and units[-1][0] == cls
                and (cls == "diag"
                     or not (set(op.targets)
                             & {t for o in units[-1][1] for t in o.targets}))):
            units[-1][1].append(op)
        else:
            units.append((cls, [op]))
    return units


def supports(ansatz) -> bool:
    """True when every op of the ansatz has a kernel lowering here."""
    return plan_units(ansatz.ops, ansatz.n) is not None


# ---------------------------------------------------------------------------
# Applying a unit
# ---------------------------------------------------------------------------


def unit_calls(unit, theta: np.ndarray, n: int, device, dag: bool = False) -> list:
    """The kernel calls of one unit (or its dagger) at ``theta`` (float64
    host values): ``[(wrapper name in ops.kernels, operands)]``, with the
    operands built on the host and, for a CUDA device, uploaded (this is
    the host work per call that descriptors built once would save)."""
    kind, ops = unit
    b = max(n - A._COL, 0)
    if kind == "1q":
        row = sorted((op for op in ops if op.targets[0] < b), key=lambda o: o.targets[0])
        lane = {op.targets[0]: op for op in ops if op.targets[0] >= b}
        calls = []
        for i in range(0, len(row), kernels._LAYER1Q_MAX):
            chunk = row[i:i + kernels._LAYER1Q_MAX]
            calls.append(("layer1q", (tuple((_op_matrix(op, theta, dag)[1], op.targets[0])
                                            for op in chunk),)))
        if lane:
            u = np.ones((1, 1), dtype=np.complex128)
            for q in range(b, n):
                u = np.kron(u, _op_matrix(lane[q], theta, dag)[1] if q in lane else np.eye(2))
            calls.append(("lane", (kernels.lane_prepare(u, n, device),)))
        return calls
    if kind == "diag":
        factors = tuple((_op_matrix(op, theta, dag)[1], tuple(op.targets)) for op in ops)
        return [plan(DiagLayer(factors), n, device)]
    (op,) = ops
    u, targets = A._sort_targets(_op_matrix(op, theta, dag)[1], tuple(op.targets))
    return [plan(DenseOp(u, targets), n, device)]


def apply_unit(state: torch.Tensor, unit, theta: np.ndarray, n: int,
               dag: bool = False) -> torch.Tensor:
    """A unit (or its dagger) applied to ``state`` in place: its operands
    built and its kernels launched in a ``qubism.adjoint.sweep`` span."""
    with profiling.span("qubism.adjoint.sweep"):
        for name, args in unit_calls(unit, theta, n, state.device, dag):
            getattr(kernels, name)(state, *args, n)
    return state


def predicted_launches(ansatz) -> dict:
    """Kernel launches of one engine call, from :func:`plan_units`: each
    unit's launches once in the forward sweep and twice in the reverse one
    (phi and lam); a diag call counts one launch per pass."""
    n = ansatz.n
    theta = np.zeros(ansatz.num_params)
    counts: dict[str, int] = {}
    for unit in plan_units(ansatz.ops, n):
        for name, args in unit_calls(unit, theta, n, torch.device("cpu")):
            k = len(kernels._diag_passes(args[0].factors, n)) if name == "diag" else 1
            counts[name] = counts.get(name, 0) + 3 * k
    return counts


# ---------------------------------------------------------------------------
# Gradient contraction and heads
# ---------------------------------------------------------------------------


#: log2 of the chunk of the state that :func:`diag_head` builds its weights
#: for at a time: 2^28 float32 weights (1 GiB) a chunk
_HEAD_CHUNK = 28


def contraction_plan(units, n: int):
    """The gradient walks of the reverse sweep, built once per engine: for
    each unit, last first, its walks ``[(flip mask, sign masks, first
    slot)]`` (its generator terms grouped by flip mask, one
    :func:`ops.measure.pauli_pair_sums` walk a group), and for each slot of
    the sums' buffer ``(parameter index, scale * coefficient, #Y)``, in the
    order the walks fill the slots."""
    walks, slots = [], []
    for unit in reversed(units):
        entries = [(op.pidx[0], op.scale * coef, pauli) for op in unit[1]
                   if isinstance(op, PGate) for coef, pauli in _gen_terms(op, n)]
        paulis = [p for _, _, p in entries]
        mine = []
        for f, idxs in M.group_terms(paulis).items():
            mine.append((f, [M.pauli_masks(paulis[j])[1] for j in idxs], len(slots)))
            slots += [(entries[j][0], entries[j][1], paulis[j].count("Y")) for j in idxs]
        walks.append(mine)
    return walks, slots


def unit_walks(phi: torch.Tensor, lam: torch.Tensor, walks, n: int):
    """Add a unit's ``<lam|P phi>`` sums (without their i^{#Y}) into their
    slots of the call's float64 sums buffer on phi's device, from the (phi,
    lam) pair at the unit's after boundary: one
    :func:`ops.measure.pauli_pair_sums` walk per flip mask of the unit,
    ``walks`` = [(flip mask, sign masks, the slots' view of the buffer)],
    in a ``qubism.adjoint.contract`` span. Nothing is read back here."""
    if not walks:
        return
    with profiling.span("qubism.adjoint.contract"):
        for f, zs, out in walks:
            M.pauli_pair_sums(phi, lam, n, f, zs, out=out)


def add_grads(sums: np.ndarray, slots, g: np.ndarray):
    """Add ``2 s Im(i^{#Y} <lam|P phi>)`` of every slot into ``g``
    (float64), from the sums read back from the buffer."""
    for (pidx, sc, n_y), (re, im) in zip(slots, sums):
        g[pidx] += 2.0 * sc * M._apply_iy(re, im, n_y).imag


def diag_head(phi: torch.Tensor, n: int, checked, constant: float):
    """(E, lam = H phi) for a diagonal H (I/Z strings only): lam(x) = w(x)
    phi(x) with w(x) = sum_j c_j s_j(x), and E = <phi|lam> + constant. w is
    built one chunk of 2^_HEAD_CHUNK indices at a time from the row and
    column sign tables (one small matmul per chunk), never as a 2^n table;
    E is one pair sum (``kernels.pair_sums``, float64). The tables' uploads
    and E's read-back count as ``syncs``."""
    dev = phi.device
    zs = [M.pauli_masks(p)[1] for _, p in checked]
    coefs = np.array([c for c, _ in checked], dtype=np.float64)
    (_, lr, lc), _, _, srows, scols, shi = M._walk(n, 0, zs, dev, chunk=_HEAD_CHUNK)
    srow = A.to_device(srows.T.astype(np.float32), dev)            # (2^lr, k)
    scol = A.to_device(scols.astype(np.float32), dev)              # (k, 2^lc)
    chunk_coefs = A.to_device((shi * coefs[None, :]).astype(np.float32), dev)
    lam = torch.empty_like(phi)
    pv = phi.view(-1, 1 << lr, 1 << lc)
    lv = lam.view(-1, 1 << lr, 1 << lc)
    for h in range(pv.shape[0]):
        w = (srow * chunk_coefs[h]) @ scol
        torch.mul(pv[h], w, out=lv[h])
    e = kernels.pair_sums(lam, phi, 0, [0], torch.zeros(1, 2, dtype=torch.float64, device=dev), n)
    return float(A.to_host(e)[0, 0]) + constant, lam


def pauli_head(phi: torch.Tensor, n: int, checked, constant: float):
    """(E, lam = H phi) for any Pauli sum: the grouped expectation and
    :func:`ops.measure.apply_pauli_sum`."""
    return (M.expectation_pauli_sum(phi, n, checked) + constant,
            M.apply_pauli_sum(phi, checked, n))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def kernel_adjoint_value_and_grad_fn(ansatz, terms, constant: float = 0.0,
                                     units_per_chunk: int = 4):
    """``theta -> (energy, dE/dtheta)``: the adjoint sweep on the kernels,
    in place on two state buffers (phi, lam) of ``config.device``; on a
    CPU device every wrapper runs its plain version. Energy and gradient
    come back as float32 CPU tensors; the callable's ``_engine`` is
    ``"kernels"``. Raises ValueError when some op has no kernel lowering
    (``variational.adjoint_value_and_grad_fn(engine="auto")`` routes such
    an ansatz to the plain sweep). ``units_per_chunk`` is the JAX engine's
    jit chunking and changes nothing here.

    A call runs in a ``qubism.adjoint`` span, its head (E and lam = H phi)
    in ``qubism.adjoint.head``. Its gradient walks add their sums into one
    float64 buffer on the state's device, read back once at the end of the
    call (the callable's ``_contract`` is ``"device"``)."""
    del units_per_chunk
    n = ansatz.n
    units = plan_units(ansatz.ops, n)
    if units is None:
        raise ValueError("ansatz has ops without a kernel lowering (a parameterized dense "
                         "gate on >= 2 qubits, a multi-parameter gate, or a dense prim on "
                         "more than 4 qubits off the lane block)")
    _, checked = _check_terms(terms, n)
    diagonal = all(set(p) <= set("IZ") for _, p in checked)
    walks, slots = contraction_plan(units, n)
    buffers = {}

    def sums_buffer(dev):
        """The sums buffer on ``dev``, zeroed, and each unit's walks with
        their views of it, last unit first (made once per device)."""
        if dev in buffers:
            buffers[dev][0].zero_()
        else:
            sums = torch.zeros(len(slots), 2, dtype=torch.float64, device=dev)
            buffers[dev] = sums, [[(f, zs, sums[first:first + len(zs)]) for f, zs, first in unit]
                                  for unit in walks]
        return buffers[dev]

    def vg(theta):
        with profiling.span("qubism.adjoint"):
            th = _host_theta(theta)
            phi = A.zero_state(n)
            for unit in units:
                apply_unit(phi, unit, th, n)
            with profiling.span("qubism.adjoint.head"):
                e, lam = (diag_head if diagonal else pauli_head)(phi, n, checked,
                                                                 float(constant))
            sums, unit_walk_views = sums_buffer(phi.device)
            for unit, views in zip(reversed(units), unit_walk_views):
                unit_walks(phi, lam, views, n)
                apply_unit(phi, unit, th, n, dag=True)
                apply_unit(lam, unit, th, n, dag=True)
            g = np.zeros(ansatz.num_params)
            add_grads(A.to_host(sums), slots, g)
        return torch.tensor(e, dtype=torch.float32), torch.from_numpy(g.astype(np.float32))

    vg._engine = "kernels"
    vg._contract = "device"
    return vg
