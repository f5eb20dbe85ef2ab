"""The five state-vector kernels of the engine.

Each kernel has three parts here:

* a **wrapper** (``gate``, ``diag``, ``lane``, ``layer1q``, ``stage_block``)
  that updates a state tensor in place. On a CUDA tensor it launches the
  hand-written Hopper kernel from ``qubism_torch/csrc`` (built by
  :mod:`.build`) or raises; on a CPU tensor it runs the plain version.
  Nothing else selects between the two: no fallback, no size threshold.
* a **plain version** (``*_plain``) of the same function in torch ops, on
  any device. The CPU tests use it, and ``chip_smoke.py`` holds each kernel
  against it on the card.
* a **launch counter**, ``launches[name]``, incremented where the kernel is
  launched and nowhere else.

Every wrapper takes the state (complex64, contiguous, length 2^n), its
operands, and n, and returns the state. The operands the diag, lane and
stage kernels read from device memory can be prepared once
(:func:`diag_prepare`, :func:`lane_prepare`, :func:`stage_block_prepare`),
so that a compiled circuit launches kernels without a host-to-device copy;
the diag and lane wrappers also take raw host operands and upload them.
:data:`KERNEL_FNS` maps each kernel name to its (wrapper, plain version).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .apply import _COL, as_operand, canonical_device, target_view

#: kernel launches per wrapper since the last :func:`reset_launches`
launches = {"gate": 0, "diag": 0, "lane": 0, "layer1q": 0, "stage": 0}

#: widest diagonal factor held as a table (2^7 entries: the widest factor
#: fusion emits, a pure-lane union). Wider factors are split exactly into
#: (mask, phase) pairs by :func:`_split_factor_phases`.
_TABLE_BITS_MAX = 7
#: per-pass budgets of the diag kernel's shared memory (entries, factors):
#: 4096 * 8 B of tables + 64 descriptors stay under the 48 KB a block gets
#: without opting in
_DIAG_PASS_ENTRIES = 4096
_DIAG_PASS_FACTORS = 64
#: int32 words per diag factor descriptor (kDescWords in csrc/diag.cu): k,
#: table offset, mask lo, mask hi, then up to 8 bit positions of its targets
#: (MSB of the table index first)
_DESC_WORDS = 12

_LAYER1Q_MAX = 6


def reset_launches():
    for k in launches:
        launches[k] = 0


def _check_state(state: torch.Tensor, n: int):
    if state.dtype != torch.complex64 or not state.is_contiguous() or state.numel() != (1 << n):
        raise ValueError(
            f"state must be a contiguous complex64 tensor of 2^{n} elements, got "
            f"{state.dtype} {tuple(state.shape)} contiguous={state.is_contiguous()}")


def _check_plan_device(name: str, plan_device, state: torch.Tensor):
    if plan_device != state.device:
        raise ValueError(f"{name}: operands prepared for {plan_device}, "
                         f"state on {state.device}")


def _launch(state: torch.Tensor, name: str, call, counts=None):
    """Run ``call(lib, device index, stream)`` for a CUDA state and count
    the launch in ``counts[name]`` (default :data:`launches`)."""
    from . import build

    if state.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for a state on {state.device}")
    lib = build.library()
    dev = state.device.index if state.device.index is not None else torch.cuda.current_device()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    rc = call(lib, dev, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.qk_error_string(rc).decode()} ({rc})")
    (launches if counts is None else counts)[name] += 1
    return state


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _host(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _positions(targets, n: int) -> np.ndarray:
    """Bit position of each target in the amplitude index (qubit q = bit
    n-1-q), in the given order."""
    return np.array([n - 1 - t for t in targets], dtype=np.int64)


# ---------------------------------------------------------------------------
# K1: dense gate on <= 4 targets
# ---------------------------------------------------------------------------


def gate_plain(state: torch.Tensor, u, targets: tuple[int, ...], n: int) -> torch.Tensor:
    """y = U x on the sorted ``targets`` (targets[0] = MSB of U's index):
    the target axes are moved last and contracted with one matmul."""
    k = len(targets)
    dims, axes = target_view(n, targets)
    rest = [a for a in range(len(dims)) if a not in axes]
    perm = rest + axes
    x = state.view(dims).permute(perm)
    y = x.reshape(-1, 1 << k) @ as_operand(u, state).T
    inv = [perm.index(a) for a in range(len(dims))]
    state.view(dims).copy_(y.view([dims[a] for a in perm]).permute(inv))
    return state


def gate(state: torch.Tensor, u, targets: tuple[int, ...], n: int) -> torch.Tensor:
    """Dense 2^k x 2^k complex gate, 1 <= k <= 4, on sorted ``targets``,
    in place."""
    k = len(targets)
    if not 1 <= k <= 4 or list(targets) != sorted(set(targets)):
        raise ValueError(f"gate: targets {targets} must be 1..4 sorted distinct qubits")
    _check_state(state, n)
    if state.device.type == "cpu":
        return gate_plain(state, u, targets, n)
    coef = np.ascontiguousarray(np.asarray(u, dtype=np.complex64))
    if coef.shape != (1 << k, 1 << k):
        raise ValueError(f"gate: matrix shape {coef.shape} != {(1 << k, 1 << k)}")
    pos = _positions(targets, n)
    return _launch(state, "gate", lambda lib, d, s: lib.qk_gate(
        _ptr(state), n, k, _host(pos), _host(coef), d, s))


# ---------------------------------------------------------------------------
# K4: a layer of disjoint 1q gates
# ---------------------------------------------------------------------------


def layer1q_plain(state: torch.Tensor, gates, n: int) -> torch.Tensor:
    """The gates of ``gates`` = ((u (2,2), q), ...) one after another."""
    for u, q in gates:
        gate_plain(state, u, (q,), n)
    return state


def layer1q(state: torch.Tensor, gates, n: int) -> torch.Tensor:
    """m <= 6 single-qubit gates on distinct qubits in one pass, in place."""
    m = len(gates)
    qs = [int(q) for _, q in gates]
    if not 1 <= m <= _LAYER1Q_MAX or len(set(qs)) != m:
        raise ValueError(f"layer1q: need 1..{_LAYER1Q_MAX} distinct qubits, got {qs}")
    _check_state(state, n)
    if state.device.type == "cpu":
        return layer1q_plain(state, gates, n)
    coef = np.ascontiguousarray(
        np.stack([np.asarray(u, dtype=np.complex64).reshape(2, 2) for u, _ in gates]))
    pos = _positions(qs, n)
    return _launch(state, "layer1q", lambda lib, d, s: lib.qk_layer1q(
        _ptr(state), n, m, _host(pos), _host(coef), d, s))


# ---------------------------------------------------------------------------
# K3: dense gate over the lane block (the last 7 qubits)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LanePlan:
    """A lane gate's operands: ``u`` (L, L) on the host and, for a CUDA
    device, ``ut`` = U^T as a complex64 device tensor."""

    u: np.ndarray
    device: torch.device
    ut: torch.Tensor | None


def lane_prepare(u, n: int, device) -> LanePlan:
    """Check a lane matrix (L = 2^min(n,7)) and upload U^T for a CUDA
    device."""
    lanes = 1 << min(n, _COL)
    u = np.asarray(u)
    if u.shape != (lanes, lanes):
        raise ValueError(f"lane: matrix shape {u.shape} != {(lanes, lanes)}")
    device = canonical_device(device)
    ut = None
    if device.type != "cpu":
        # the kernel reads U^T so that a warp's lanes read consecutive columns
        ut = torch.from_numpy(np.ascontiguousarray(u.T, dtype=np.complex64)).to(device)
    return LanePlan(u, device, ut)


def lane_plain(state: torch.Tensor, u, n: int) -> torch.Tensor:
    """Every row of 2^min(n,7) amplitudes times U^T (``u`` a matrix or a
    :class:`LanePlan`)."""
    if isinstance(u, LanePlan):
        u = u.u
    lanes = 1 << min(n, _COL)
    x = state.view(-1, lanes)
    x.copy_(x @ as_operand(u, state).T)
    return state


def lane(state: torch.Tensor, u, n: int) -> torch.Tensor:
    """A gate expanded over the whole lane block (u: (L, L) complex with
    L = 2^min(n,7), see apply.expand_for_view, or its :class:`LanePlan`),
    in place."""
    plan = u if isinstance(u, LanePlan) else lane_prepare(u, n, state.device)
    _check_state(state, n)
    if state.device.type == "cpu":
        return lane_plain(state, plan.u, n)
    _check_plan_device("lane", plan.device, state)
    return _launch(state, "lane", lambda lib, d, s: lib.qk_lane(
        _ptr(state), n, _ptr(plan.ut), d, s))


# ---------------------------------------------------------------------------
# K2: a layer of commuting diagonal factors
# ---------------------------------------------------------------------------


def diag_plain(state: torch.Tensor, factors, n: int) -> torch.Tensor:
    """Multiply by each factor (d (2^k,), targets) in turn: a broadcast
    multiply over a minimal-rank view of the target axes. ``factors`` may
    be a :class:`DiagPlan`."""
    if isinstance(factors, DiagPlan):
        factors = factors.factors
    for d, targets in factors:
        d = np.asarray(d, dtype=np.complex128)
        k = len(targets)
        order = sorted(range(k), key=lambda j: targets[j])
        srt = tuple(targets[j] for j in order)
        table = d.reshape((2,) * k).transpose(order)
        dims, axes = target_view(n, srt)
        shape = [1] * len(dims)
        for a in axes:
            shape[a] = 2
        state.view(dims).mul_(as_operand(table, state).reshape(shape))
    return state


def _split_factor_phases(f):
    """Exact multiplicative split of one diagonal factor into
    multi-controlled-phase factors.

    Writes d[bits] = exp(L[bits]) and expands L multilinearly over the
    bit lattice (Moebius transform): L[b] = sum_{S subseteq b} c_S, so
    d = prod_S cphase(exp(c_S) on targets S). Exact for any zero-free
    diagonal (unitary diagonals are unit-modulus; branch cuts cancel in
    exp). Returns None when d has zero entries (log undefined)."""
    d, targets = f
    k = len(targets)
    d = np.asarray(d, dtype=np.complex128).ravel()
    if np.any(np.abs(d) < 1e-300):
        return None
    c = np.log(d.copy())
    for j in range(k):
        bit = 1 << j
        hi = (np.arange(1 << k) & bit).astype(bool)
        c[hi] -= c[np.arange(1 << k)[hi] ^ bit]
    # array index bit (k-1-j) corresponds to targets[j] (MSB-first)
    out = []
    for s in range(1, 1 << k):
        if abs(c[s]) < 1e-14:
            continue
        sub = tuple(targets[j] for j in range(k) if s & (1 << (k - 1 - j)))
        m = len(sub)
        ds = np.ones(1 << m, dtype=np.complex128)
        ds[-1] = np.exp(c[s])
        out.append((ds, sub))
    glob = np.exp(c[0])
    if abs(glob - 1.0) > 1e-14:
        if out:
            d0, t0 = out[0]
            out[0] = (d0 * glob, t0)
        else:
            out.append((np.array([glob, glob]), (targets[0],)))
    return out


def _mask_factors(f, n: int):
    """A factor wider than _TABLE_BITS_MAX as (mask, value, phase)
    triples: the amplitude is multiplied by ``phase`` where its bits under
    ``mask`` read ``value`` (mask 0 = every amplitude). A factor that takes
    one common value except at fewer than _DIAG_PASS_FACTORS points (a
    Grover oracle's phase flip) becomes that value plus one triple per
    point; any other factor is split exactly into multi-controlled phases
    (:func:`_split_factor_phases`)."""
    d, targets = f
    d = np.asarray(d, dtype=np.complex128).ravel()
    if np.any(np.abs(d) < 1e-300):
        raise ValueError(f"diag: factor on {targets} has a zero entry; it cannot "
                         f"be split into phases")
    k = len(targets)
    vals, counts = np.unique(d, return_counts=True)
    common = vals[np.argmax(counts)]
    points = np.flatnonzero(d != common)
    if len(points) < _DIAG_PASS_FACTORS:
        full = 0
        for t in targets:
            full |= 1 << (n - 1 - t)
        out = [(0, 0, common)] if common != 1 else []
        for b in points:
            value = 0
            for j, t in enumerate(targets):
                value |= ((int(b) >> (k - 1 - j)) & 1) << (n - 1 - t)
            out.append((full, value, d[b] / common))
        return out
    out = []
    for ds, sub in _split_factor_phases((d, targets)):
        mask = 0
        for t in sub:
            mask |= 1 << (n - 1 - t)
        g = ds[0]
        if g != 1:  # the global phase folded into the first part
            out.append((0, 0, g))
        out.append((mask, mask, ds[-1] / g))
    return out


def _words(v: int) -> np.ndarray:
    """A 64-bit mask as two int32 words (lo, hi)."""
    return np.array([v & 0xFFFFFFFF, v >> 32], dtype=np.uint32).view(np.int32)


def _diag_passes(factors, n: int):
    """Host side of K2: [(tables complex64 (T,), desc int32 (F, W))] per
    kernel pass, each within the shared-memory budget."""
    items = []  # (k, table (2^k,), positions) or (0, [phase], (mask, value))
    for d, targets in factors:
        d = np.asarray(d, dtype=np.complex128).ravel()
        if len(targets) > _TABLE_BITS_MAX:
            items.extend((0, np.array([p]), (m, v))
                         for m, v, p in _mask_factors((d, targets), n))
        else:
            items.append((len(targets), d, _positions(targets, n)))
    passes, cur, entries = [], [], 0
    for it in items:
        size = len(it[1])
        if cur and (entries + size > _DIAG_PASS_ENTRIES or len(cur) == _DIAG_PASS_FACTORS):
            passes.append(cur)
            cur, entries = [], 0
        cur.append(it)
        entries += size
    if cur:
        passes.append(cur)
    out = []
    for group in passes:
        tables = np.concatenate([t for _, t, _ in group]).astype(np.complex64)
        desc = np.zeros((len(group), _DESC_WORDS), dtype=np.int32)
        off = 0
        for f, (k, table, where) in enumerate(group):
            desc[f, 0] = k
            desc[f, 1] = off
            if k:
                desc[f, 4:4 + k] = where
            else:
                desc[f, 2:4] = _words(where[0])
                desc[f, 4:6] = _words(where[1])
            off += len(table)
        out.append((tables, desc))
    return out


@dataclass(frozen=True)
class DiagPlan:
    """A diagonal layer's operands: the host ``factors`` and, for a CUDA
    device, the (tables, descriptors) device tensors of each kernel pass."""

    factors: tuple
    device: torch.device
    passes: tuple


def diag_prepare(factors, n: int, device) -> DiagPlan:
    """Build (and for a CUDA device upload) the diag kernel's passes."""
    factors = tuple(factors)
    device = canonical_device(device)
    passes = ()
    if device.type != "cpu":
        passes = tuple((torch.from_numpy(t).to(device), torch.from_numpy(d).to(device))
                       for t, d in _diag_passes(factors, n))
    return DiagPlan(factors, device, passes)


def diag(state: torch.Tensor, factors, n: int) -> torch.Tensor:
    """The product of commuting diagonal factors ((d (2^k,), targets), ...,
    or their :class:`DiagPlan`) in one pass per shared-memory budget, in
    place."""
    _check_state(state, n)
    if state.device.type == "cpu":
        return diag_plain(state, factors, n)
    plan = factors if isinstance(factors, DiagPlan) else diag_prepare(factors, n, state.device)
    _check_plan_device("diag", plan.device, state)
    for tab, dsc in plan.passes:
        _launch(state, "diag", lambda lib, d, s: lib.qk_diag(
            _ptr(state), n, _ptr(tab), tab.numel(), _ptr(dsc), dsc.shape[0], d, s))
    return state


# ---------------------------------------------------------------------------
# K5: a block of k <= 4 QFT stages
# ---------------------------------------------------------------------------

#: low index bits per phase-table chunk, and the most chunks the kernel
#: stages (csrc/stage.cu: kChunkBits, kMaxChunks)
_CHUNK_BITS = 8
_MAX_CHUNKS = 4


@dataclass(frozen=True)
class StagePlan:
    """The operands of one stage block (see :func:`stage_block_prepare`).

    ``coef`` is the folded (2^k, 2^k) block C, index bit k-1-t = stage t;
    ``tables[t, c, e]`` is stage t's outside-ladder phase for the value
    ``e`` of index bits [8c, 8c + 8); ``dev_tables`` is ``tables`` as a
    complex64 tensor on a CUDA device (None for the CPU)."""

    stages: tuple
    targets: tuple
    coef: np.ndarray
    tables: np.ndarray
    device: torch.device
    dev_tables: torch.Tensor | None

    @property
    def chunks(self) -> int:
        return self.tables.shape[1]


def stage_block_prepare(stages, n: int, device) -> StagePlan:
    """Host side of K5 for a block of k <= 4 stages
    ((u (2,2), q, ladder), ...), q strictly ascending, where each ladder is
    ((d (4,), (q, j)), ...) with j > q and d[0] = d[1] = 1.

    Ladder factors between two of the block's qubits see stage t's OUTPUT
    bit and stage s's INPUT bit (the ladder sits between U_t and U_s), so
    they fold with the 1q gates into one coefficient block:

        C[i, j] = prod_t U_t[i_t, j_t] * prod_{(t,s)} d_ts[(i_t << 1) | j_s]

    Every other ladder bit j lies below the block (asserted), so stage t's
    phase from those factors, P_t, depends only on the low n-1-q_k index
    bits; it is tabulated per byte of them: a factor whose bit reads 1
    contributes d[3], else d[2]."""
    stages = tuple(stages)
    k = len(stages)
    if not 1 <= k <= 4:
        raise ValueError(f"stage block of {k} stages: 1..4 supported")
    targets = tuple(int(q) for _, q, _ in stages)
    if any(targets[i] >= targets[i + 1] for i in range(k - 1)):
        raise ValueError(f"stage qubits {targets} are not strictly ascending")
    slot = {q: t for t, q in enumerate(targets)}

    intra: dict[tuple[int, int], np.ndarray] = {}
    outside = []  # per stage: [(d, bit position)]
    for t, (_, q, ladder) in enumerate(stages):
        rest = []
        for d, (qq, j) in ladder:
            d = np.asarray(d, dtype=np.complex128)
            if qq != q or j <= q or d[0] != 1 or d[1] != 1:
                raise ValueError(f"stage on {q}: ({qq}, {j}) is not a ladder factor")
            if j in slot:
                intra[(t, slot[j])] = intra.get((t, slot[j]), 1) * d
            elif j > targets[-1]:
                rest.append((d, n - 1 - j))
            else:
                raise ValueError(f"ladder bit {j} lies inside the block {targets}")
        outside.append(rest)

    dim = 1 << k
    bits = (np.arange(dim)[:, None] >> (k - 1 - np.arange(k))[None, :]) & 1  # (dim, k)
    coef = np.ones((dim, dim), dtype=np.complex128)
    for t, (u, _, _) in enumerate(stages):
        u = np.asarray(u, dtype=np.complex128)
        coef *= u[bits[:, t][:, None], bits[:, t][None, :]]
    for (t, s), d in intra.items():
        coef *= d[(bits[:, t][:, None] << 1) | bits[:, s][None, :]]

    top = max((p for rest in outside for _, p in rest), default=-1)
    chunks = top // _CHUNK_BITS + 1
    if chunks > _MAX_CHUNKS:
        raise ValueError(f"stage block: ladder bit {top} needs {chunks} table "
                         f"chunks (> {_MAX_CHUNKS})")
    entry = np.arange(1 << _CHUNK_BITS)
    tables = np.ones((k, chunks, 1 << _CHUNK_BITS), dtype=np.complex128)
    for t, rest in enumerate(outside):
        for d, p in rest:
            on = ((entry >> (p % _CHUNK_BITS)) & 1) == 1
            tables[t, p // _CHUNK_BITS] *= np.where(on, d[3], d[2])

    device = canonical_device(device)
    dev_tables = None
    if device.type != "cpu" and chunks:
        dev_tables = torch.from_numpy(tables.astype(np.complex64)).to(device)
    return StagePlan(stages, targets, coef, tables, device, dev_tables)


def stage_block_plain(state: torch.Tensor, stages, n: int) -> torch.Tensor:
    """Each stage as written: its 1q gate, then its ladder (``stages``
    may be a :class:`StagePlan`)."""
    if isinstance(stages, StagePlan):
        stages = stages.stages
    for u, q, ladder in stages:
        gate_plain(state, u, (q,), n)
        if ladder:
            diag_plain(state, ladder, n)
    return state


def stage_block(state: torch.Tensor, plan: StagePlan, n: int) -> torch.Tensor:
    """A block of k <= 4 QFT stages in one pass, in place."""
    _check_state(state, n)
    if state.device.type == "cpu":
        return stage_block_plain(state, plan.stages, n)
    _check_plan_device("stage", plan.device, state)
    k = len(plan.targets)
    coef = np.ascontiguousarray(plan.coef, dtype=np.complex64)
    pos = _positions(plan.targets, n)
    tab = _ptr(plan.dev_tables) if plan.dev_tables is not None else ctypes.c_void_p(None)
    return _launch(state, "stage", lambda lib, d, s: lib.qk_stage(
        _ptr(state), n, k, _host(pos), _host(coef), tab, plan.chunks, d, s))


#: kernel name -> (wrapper, plain version); both take (state, *operands, n)
KERNEL_FNS = {
    "gate": (gate, gate_plain),
    "diag": (diag, diag_plain),
    "lane": (lane, lane_plain),
    "layer1q": (layer1q, layer1q_plain),
    "stage": (stage_block, stage_block_plain),
}
