"""The seven state-vector kernels of the engine, and the pair reduction.

Each kernel has three parts here:

* a **wrapper** (``gate``, ``diag``, ``lane``, ``layer1q``, ``stage_block``,
  ``shard_butterfly``, ``permute``) that updates a state tensor in place.
  On a CUDA tensor it launches the hand-written Hopper kernel from
  ``qubism_torch/csrc`` (built by :mod:`.build`) or raises; on a CPU tensor
  it runs the plain version.
  Nothing else selects between the two: no fallback, no size threshold.
* a **plain version** (``*_plain``) of the same function in torch ops, on
  any device. The CPU tests use it, and ``chip_smoke.py`` holds each kernel
  against it on the card.
* a **launch counter**, ``launches[name]``, incremented where the kernel is
  launched and nowhere else.

Every wrapper but ``shard_butterfly`` takes the state (complex64,
contiguous, length 2^n), its operands, and n, and returns the state;
``shard_butterfly`` takes the S banks of the mesh path in place of the state
(:mod:`qubism_torch.parallel.sharded`). The operands the diag, lane and
stage kernels read from device memory can be prepared once
(:func:`diag_prepare`, :func:`lane_prepare`, :func:`stage_block_prepare`),
so that a compiled circuit launches kernels without a host-to-device copy;
the diag and lane wrappers also take raw host operands and upload them.
The permute kernel's tile layout is made on the host
(:func:`permute_prepare`) and read from its parameters. K1, K4 and K3 also
have a device-operand mode (:func:`gate_dev`, :func:`layer1q_dev`,
:func:`lane_dev`): the matrix is a complex64 tensor on
the state's device, chosen there (a trajectory's realized operand, an MCWF
branch), so a run of launches needs no host copy at all; they count their
launches under the same names and their plain versions are the same.
:data:`KERNEL_FNS` maps each kernel name to its (wrapper, plain version).

The pair reduction (:func:`pair_sums`, ``csrc/pair.cu``) reads two states
and adds the sums of :func:`.measure.pauli_pair_sums` into a float64 tensor
on their device; its plain version is that function's chunk walk, and it
counts under ``launches["pair"]``. It updates no state, so it is not in
:data:`KERNEL_FNS`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..utils import profiling
from .apply import _COL, as_operand, canonical_device, target_view, to_device

#: kernel launches per wrapper since the last :func:`reset_launches`
launches = {"gate": 0, "diag": 0, "lane": 0, "layer1q": 0, "stage": 0, "butterfly": 0,
            "permute": 0, "pair": 0}

#: widest diagonal factor held as a table (2^7 entries: the widest factor
#: fusion emits, a pure-lane union). Wider factors are split exactly into
#: (mask, phase) pairs by :func:`_split_factor_phases`.
_TABLE_BITS_MAX = 7
#: per-pass budgets of the diag kernel's shared memory (entries, factors):
#: 4096 * 8 B of tables + 64 descriptors of 64 B stay under the 48 KB a
#: block gets without opting in
_DIAG_PASS_ENTRIES = 4096
_DIAG_PASS_FACTORS = 64
#: int32 words per diag factor descriptor (kDescWords in csrc/diag.cu), the
#: word of the first run and of the first position byte
_DESC_WORDS = 16
_DESC_RUN, _DESC_DELTA = 2, 12
#: a diag thread owns 2^M vectors of two amplitudes, M <= 3 thread bits at
#: positions >= 6 where the state has them (a warp then still moves 512
#: contiguous bytes per vector)
_THREAD_BITS_MAX = 3
_THREAD_BIT_FLOOR = 6

_LAYER1Q_MAX = 6


def reset_launches():
    """Zero :data:`launches` and clear the port's counters
    (``utils.profiling.counters``)."""
    for k in launches:
        launches[k] = 0
    profiling.counters.clear()


def _check_state(state: torch.Tensor, n: int):
    if state.dtype != torch.complex64 or not state.is_contiguous() or state.numel() != (1 << n):
        raise ValueError(
            f"state must be a contiguous complex64 tensor of 2^{n} elements, got "
            f"{state.dtype} {tuple(state.shape)} contiguous={state.is_contiguous()}")


def _check_plan_device(name: str, plan_device, state: torch.Tensor):
    if plan_device != state.device:
        raise ValueError(f"{name}: operands prepared for {plan_device}, "
                         f"state on {state.device}")


def _check_aligned(name: str, state: torch.Tensor):
    if state.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes a state aligned to 16 bytes")


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


def _check_operand(name: str, t, shape, state: torch.Tensor):
    """A device operand: a contiguous complex64 tensor of ``shape`` on the
    state's device, 8-byte aligned (the kernels read it as float2)."""
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.complex64
            or not t.is_contiguous() or tuple(t.shape) != tuple(shape)
            or t.device != state.device or t.data_ptr() % 8):
        got = (f"{t.dtype} {tuple(t.shape)} on {t.device}" if isinstance(t, torch.Tensor)
               else type(t).__name__)
        raise ValueError(f"{name}: the device operand must be a contiguous complex64 "
                         f"tensor {tuple(shape)} on {state.device}, got {got}")


def gate_dev(state: torch.Tensor, u: torch.Tensor, targets: tuple[int, ...],
             n: int) -> torch.Tensor:
    """:func:`gate` with U a complex64 (2^k, 2^k) tensor on the state's
    device (a slice of a batch of operands, or a matrix computed there): the
    kernel reads it from device memory, so no host copy of U is needed. Its
    plain version is :func:`gate_plain` with the tensor."""
    k = len(targets)
    if not 1 <= k <= 4 or list(targets) != sorted(set(targets)):
        raise ValueError(f"gate: targets {targets} must be 1..4 sorted distinct qubits")
    _check_state(state, n)
    if state.device.type == "cpu":
        return gate_plain(state, u, targets, n)
    _check_operand("gate", u, (1 << k, 1 << k), state)
    pos = _positions(targets, n)
    return _launch(state, "gate", lambda lib, d, s: lib.qk_gate_dev(
        _ptr(state), n, k, _host(pos), _ptr(u), d, s))


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


def layer1q_dev(state: torch.Tensor, coefs: torch.Tensor, qubits, n: int) -> torch.Tensor:
    """:func:`layer1q` with the m 2x2 matrices a complex64 (m, 2, 2) tensor on
    the state's device (gate j on ``qubits[j]``), read by the kernel from
    device memory. Its plain version is :func:`layer1q_plain` with the
    tensor's matrices."""
    qs = [int(q) for q in qubits]
    m = len(qs)
    if not 1 <= m <= _LAYER1Q_MAX or len(set(qs)) != m:
        raise ValueError(f"layer1q: need 1..{_LAYER1Q_MAX} distinct qubits, got {qs}")
    _check_state(state, n)
    if state.device.type == "cpu":
        return layer1q_plain(state, tuple(zip(coefs, qs)), n)
    _check_operand("layer1q", coefs, (m, 2, 2), state)
    pos = _positions(qs, n)
    return _launch(state, "layer1q", lambda lib, d, s: lib.qk_layer1q_dev(
        _ptr(state), n, m, _host(pos), _ptr(coefs), d, s))


# ---------------------------------------------------------------------------
# K3: dense gate over the lane block (the last 7 qubits)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LanePlan:
    """A lane gate's operands: ``u`` (L, L) on the host and, for a CUDA
    device, ``dev`` = what the kernel reads, as a device tensor:
    :func:`lane_parts` of U (float32) for L = 128, U^T (complex64) for a
    smaller L."""

    u: np.ndarray
    device: torch.device
    dev: torch.Tensor | None


def round_tf32(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32's 10 mantissa bits (to nearest, on the
    bit pattern), as float32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def lane_parts(u: np.ndarray) -> np.ndarray:
    """A 128 x 128 matrix as the tensor-core kernel's shared-memory operand,
    float32 (2, 2, 32, 8, 2, 8, 4): element [h, p, 2 s + c, ng, w, r, cc] is
    TF32 part p (0: big, the value rounded to 10 mantissa bits; 1: the
    residual, exact in float32) of the real (w = 0) or imaginary (w = 1) part
    of U[64 h + 8 ng + r, 8 s + 2 cc + c]. Block h of a pair reads [h]: for
    each k8 step 2 s + c (complex input columns 8 s + 2 cc + c) and group ng
    of 8 outputs, the 8 x 4 core matrices of Ur and Ui, 128 contiguous bytes
    each (csrc/lane.cu)."""
    u = np.asarray(u, dtype=np.complex64)
    a = np.stack([u.real, u.imag]).reshape(2, 2, 8, 8, 16, 4, 2)  # w, h, ng, r, s, cc, c
    a = np.ascontiguousarray(a.transpose(1, 4, 6, 2, 0, 3, 5)).reshape(2, 32, 8, 2, 8, 4)
    big = round_tf32(a)
    return np.ascontiguousarray(np.stack([big, a - big], axis=1))


def lane_parts_dev(u: torch.Tensor) -> torch.Tensor:
    """:func:`lane_parts` of a complex64 (128, 128) tensor, computed where it
    lies: the same permutation, and the TF32 rounding on the int32 view of
    the bit pattern (a wrapping add, then the mask), so the result is bit for
    bit the host one and a matrix chosen on the card needs no host trip."""
    a = torch.view_as_real(u.resolve_conj()).permute(2, 0, 1)  # w, row, col
    a = (a.reshape(2, 2, 8, 8, 16, 4, 2).permute(1, 4, 6, 2, 0, 3, 5)
         .reshape(2, 32, 8, 2, 8, 4).contiguous())
    big = ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return torch.stack([big, a - big], dim=1)


def lane_dev(state: torch.Tensor, u: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`lane` with U a complex64 (L, L) tensor on the state's device:
    its operand (:func:`lane_parts_dev` for L = 128, U^T for a smaller L) is
    formed there, so nothing crosses from the host. Its plain version is
    :func:`lane_plain` with the tensor."""
    lanes = 1 << min(n, _COL)
    _check_state(state, n)
    if state.device.type == "cpu":
        return lane_plain(state, u, n)
    _check_operand("lane", u, (lanes, lanes), state)
    _check_aligned("lane", state)
    dev = lane_parts_dev(u) if lanes == 128 else u.T.contiguous()
    return _launch(state, "lane", lambda lib, d, s: lib.qk_lane(
        _ptr(state), n, _ptr(dev), d, s))


def lane_prepare(u, n: int, device) -> LanePlan:
    """Check a lane matrix (L = 2^min(n,7)) and upload the kernel's operand
    for a CUDA device."""
    lanes = 1 << min(n, _COL)
    u = np.asarray(u)
    if u.shape != (lanes, lanes):
        raise ValueError(f"lane: matrix shape {u.shape} != {(lanes, lanes)}")
    device = canonical_device(device)
    dev = None
    if device.type != "cpu":
        host = (lane_parts(u) if lanes == 128
                else np.ascontiguousarray(u.T, dtype=np.complex64))
        dev = to_device(host, device)
    return LanePlan(u, device, dev)


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
    in place. On a CUDA state with L = 128 the product runs on the tensor
    cores (wgmma) as three TF32 products of split operands, which keeps fp32
    accuracy; pairs of blocks share each tile of 128 rows, each holding the
    parts of half of U's rows in shared memory (:func:`lane_parts`). A
    smaller state takes a small fp32 kernel."""
    plan = u if isinstance(u, LanePlan) else lane_prepare(u, n, state.device)
    _check_state(state, n)
    if state.device.type == "cpu":
        return lane_plain(state, plan.u, n)
    _check_plan_device("lane", plan.device, state)
    _check_aligned("lane", state)
    return _launch(state, "lane", lambda lib, d, s: lib.qk_lane(
        _ptr(state), n, _ptr(plan.dev), d, s))


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


@dataclass(frozen=True)
class DiagPass:
    """What one launch of the diag kernel reads.

    ``tables`` (complex64, every factor's entries one after another) and
    ``desc`` (int32 (F, 16), one descriptor per factor, see csrc/diag.cu) are
    numpy arrays from :func:`_diag_passes` and device tensors in a
    :class:`DiagPlan`. ``own`` are the thread bits of the pass (ascending bit
    positions): a thread's amplitudes differ in bit 0 and in these. The first
    ``ninv`` descriptors are the factors that touch none of those bits.
    ``single`` = (positions, table) marks a pass of one factor on one or two
    qubits, which takes the kernel without descriptors (``tables`` and
    ``desc`` are then None)."""

    tables: object
    desc: object
    ninv: int
    own: tuple
    single: tuple | None = None


def _thread_bits(touched, n: int) -> tuple:
    """The pass's thread bits: min(3, n - 1) positions, from 6 up where the
    state has that many, that the fewest factors touch (``touched[p]`` =
    number of factors with a target at bit p); ties go to the lowest."""
    m = max(0, min(_THREAD_BITS_MAX, n - 1))
    lo = max(1, min(_THREAD_BIT_FLOOR, n - m))
    return tuple(sorted(sorted(range(lo, n), key=lambda p: (touched[p], p))[:m]))


def _runs(pairs):
    """(bit position, index bit) pairs as runs (shift, mask, left) of
    neighbouring bits: the index gets ((i >> shift) & mask) << left."""
    runs = []  # [first position, first index bit, length]
    for p, e in sorted(pairs):
        if runs and runs[-1][0] + runs[-1][2] == p and runs[-1][1] + runs[-1][2] == e:
            runs[-1][2] += 1
        else:
            runs.append([p, e, 1])
    return [(p, (1 << length) - 1, e) for p, e, length in runs]


def _diag_descriptors(group, n: int):
    """One pass's (tables, desc, ninv, own) from its items (k, table,
    positions) / (0, [phase], (mask, value))."""
    touched = [0] * max(n, 1)
    for k, _, where in group:
        for p in (where if k else [p for p in range(n) if (where[0] >> p) & 1]):
            touched[p] += 1
    own = _thread_bits(touched, n)
    bits = (0,) + own  # bit b of a position's vector number is own[b]
    offs = [(c & 1) | sum(((c >> (b + 1)) & 1) << p for b, p in enumerate(own))
            for c in range(2 << len(own))]
    own_mask = sum(1 << p for p in bits)

    rows = []  # (touches the thread's own bits, descriptor words, table)
    for k, table, where in group:
        d = [0] * _DESC_WORDS
        if k:
            pairs = [(int(p), k - 1 - j) for j, p in enumerate(where)]
            mine = [(p, e) for p, e in pairs if p in bits]
            runs = _runs([pe for pe in pairs if pe[0] not in bits])
            d[0] = len(runs)
            for r, (shift, mask, left) in enumerate(runs):
                d[_DESC_RUN + r] = shift | (mask << 8) | (left << 16)
            for c, off in enumerate(offs if mine else ()):
                delta = sum(1 << e for p, e in mine if (off >> p) & 1)
                d[_DESC_DELTA + c // 4] |= delta << (8 * (c % 4))
            variant = bool(mine)
        else:
            mask, value = where
            d[0] = 0xFFFFFFFF  # -1
            d[2], d[3] = (mask & ~own_mask) & 0xFFFFFFFF, (mask & ~own_mask) >> 32
            d[4], d[5] = (value & ~own_mask) & 0xFFFFFFFF, (value & ~own_mask) >> 32
            d[6] = sum(1 << c for c, off in enumerate(offs)
                       if (off & mask & own_mask) == (value & own_mask))
            variant = bool(mask & own_mask)
        rows.append((variant, d, table))
    rows.sort(key=lambda r: r[0])  # stable: the invariant factors first
    start = 0
    for _, d, table in rows:
        d[1] = start
        start += len(table)
    desc = np.array([d for _, d, _ in rows], dtype=np.uint32).view(np.int32)
    tables = np.concatenate([t for _, _, t in rows]).astype(np.complex64)
    ninv = sum(1 for v, _, _ in rows if not v)
    return tables, desc, ninv, own


def _diag_passes(factors, n: int) -> list:
    """Host side of K2: one :class:`DiagPass` (numpy operands) per kernel
    launch, each within the shared-memory budget."""
    items = []  # (k, table (2^k,), positions) or (0, [phase], (mask, value))
    for d, targets in factors:
        d = np.asarray(d, dtype=np.complex128).ravel()
        if len(targets) > _TABLE_BITS_MAX:
            items.extend((0, np.array([p]), (m, v))
                         for m, v, p in _mask_factors((d, targets), n))
        elif not targets:  # a scalar (a bank's share of a bank-bit diagonal)
            items.append((0, d[:1], (0, 0)))
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
        k, table, where = group[0]
        if len(group) == 1 and 1 <= k <= 2 and n >= 1:
            out.append(DiagPass(None, None, 0, (), (
                np.ascontiguousarray(where, dtype=np.int64), table.astype(np.complex64))))
        else:
            out.append(DiagPass(*_diag_descriptors(group, n)))
    return out


@dataclass(frozen=True)
class DiagPlan:
    """A diagonal layer's operands: the host ``factors`` and, for a CUDA
    device, one :class:`DiagPass` per kernel launch with its tables and
    descriptors on the device."""

    factors: tuple
    device: torch.device
    passes: tuple


def diag_prepare(factors, n: int, device) -> DiagPlan:
    """Build (and for a CUDA device upload) the diag kernel's passes."""
    factors = tuple(factors)
    device = canonical_device(device)
    passes = ()
    if device.type != "cpu":
        passes = tuple(
            p if p.single else replace(p, tables=to_device(p.tables, device),
                                       desc=to_device(p.desc, device))
            for p in _diag_passes(factors, n))
    return DiagPlan(factors, device, passes)


def diag(state: torch.Tensor, factors, n: int) -> torch.Tensor:
    """The product of commuting diagonal factors ((d (2^k,), targets), ...,
    or their :class:`DiagPlan`) in one pass per shared-memory budget, in
    place. A thread of the kernel moves 16 bytes per access and evaluates
    once what its 16 amplitudes share (see :class:`DiagPass`); a pass of one
    factor on one or two qubits needs no operand on the device."""
    _check_state(state, n)
    if state.device.type == "cpu":
        return diag_plain(state, factors, n)
    plan = factors if isinstance(factors, DiagPlan) else diag_prepare(factors, n, state.device)
    _check_plan_device("diag", plan.device, state)
    _check_aligned("diag", state)
    for p in plan.passes:
        if p.single:
            pos, table = p.single
            _launch(state, "diag", lambda lib, d, s: lib.qk_diag1(
                _ptr(state), n, len(pos), _host(pos), _host(table), d, s))
        else:
            own = np.array(p.own, dtype=np.int32)
            _launch(state, "diag", lambda lib, d, s: lib.qk_diag(
                _ptr(state), n, _ptr(p.tables), p.tables.numel(), _ptr(p.desc),
                p.desc.shape[0], p.ninv, len(own), _host(own), d, s))
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
        dev_tables = to_device(tables.astype(np.complex64), device)
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


# ---------------------------------------------------------------------------
# K6: a dense gate across whole banks (the mesh path's bank bits)
# ---------------------------------------------------------------------------

_BUTTERFLY_SIZES = (2, 4, 8, 16)


@dataclass(frozen=True)
class ButterflyPlan:
    """A cross-bank gate's operands: ``u`` (S, S) complex128 on the host and
    ``coef``, U as complex64, which the kernel takes in its parameters (no
    device copy)."""

    u: np.ndarray
    coef: np.ndarray
    device: torch.device


def shard_butterfly_prepare(u, device) -> ButterflyPlan:
    """Check an S x S gate, S in (2, 4, 8, 16), for :func:`shard_butterfly`
    on ``device``."""
    u = np.asarray(u, dtype=np.complex128)
    if u.ndim != 2 or u.shape[0] != u.shape[1] or u.shape[0] not in _BUTTERFLY_SIZES:
        raise ValueError(f"shard_butterfly: matrix shape {u.shape}; S x S with S in "
                         f"{_BUTTERFLY_SIZES} supported")
    return ButterflyPlan(u, np.ascontiguousarray(u, dtype=np.complex64),
                         canonical_device(device))


def _check_banks(banks, S: int, m: int):
    if len(banks) != S:
        raise ValueError(f"shard_butterfly: {len(banks)} banks for a {S} x {S} gate")
    for b in banks:
        _check_state(b, m)
        if b.device != banks[0].device:
            raise ValueError(f"shard_butterfly: banks on {b.device} and {banks[0].device}")
    starts = sorted(b.data_ptr() for b in banks)
    if any(hi - lo < 8 << m for lo, hi in zip(starts, starts[1:])):
        raise ValueError("shard_butterfly: banks overlap")


def shard_butterfly_plain(banks, u, m: int):
    """bank_i <- sum_j U[i, j] bank_j over the stacked banks (``u`` a matrix
    or a :class:`ButterflyPlan`); returns the banks."""
    if isinstance(u, ButterflyPlan):
        u = u.u
    x = torch.stack([b.view(-1) for b in banks])
    y = as_operand(u, x) @ x
    for b, row in zip(banks, y):
        b.view(-1).copy_(row)
    return banks


def shard_butterfly(banks, plan: ButterflyPlan, m: int):
    """A dense S x S gate across S banks of 2^m amplitudes each (all on one
    device, none overlapping), in place: bank i becomes sum_j U[i, j] bank j.
    ``plan`` is a :class:`ButterflyPlan` or the matrix."""
    if not isinstance(plan, ButterflyPlan):
        plan = shard_butterfly_prepare(plan, banks[0].device)
    S = plan.u.shape[0]
    _check_banks(banks, S, m)
    if banks[0].device.type == "cpu":
        return shard_butterfly_plain(banks, plan.u, m)
    _check_plan_device("butterfly", plan.device, banks[0])
    if m < 1 or any(b.data_ptr() % 16 for b in banks):
        raise ValueError("shard_butterfly: the kernel takes banks of >= 2 amplitudes "
                         "aligned to 16 bytes")
    ptrs = np.array([b.data_ptr() for b in banks], dtype=np.uint64)
    _launch(banks[0], "butterfly", lambda lib, d, s: lib.qk_butterfly(
        _host(ptrs), S, m, _host(plan.coef), d, s))
    return banks


# ---------------------------------------------------------------------------
# permute: a relabelling of the index bits (a run of qubit swaps)
# ---------------------------------------------------------------------------

#: csrc/permute.cu's tile: rows of 2^6 contiguous amplitudes, at most 2^12
#: amplitudes a tile, at most 16 swapped pairs of bits outside the tile
_PERMUTE_COL_BITS = 6
_PERMUTE_TILE_BITS = 12
_PERMUTE_MAX_PAIRS = 16


@dataclass(frozen=True)
class PermutePlan:
    """The tiles of one permute pass (csrc/permute.cu), laid out on the host.

    ``perm[q]`` is the qubit that qubit q's value moves to; ``sigma`` is the
    same map on bit positions (qubit q is bit n-1-q). ``tile`` holds the
    tile's bit positions, ascending: the low ``col_bits``, their images, and
    bits that sigma fixes or swaps among themselves; ``rows`` those above
    the low ``col_bits``. A destination's column bit j (row bit j) has its
    source at shared-memory offset ``wcol[j]`` (``wrow[j]``) within a tile
    buffer of rows of 2^col_bits + 1 amplitudes. ``pairs`` are the swapped
    bits outside the tile, (p, sigma[p]) with p < sigma[p]. ``packed`` is
    all of it as the kernel's parameters (int32)."""

    perm: tuple
    sigma: tuple
    col_bits: int
    tile: tuple
    rows: tuple
    wcol: tuple
    wrow: tuple
    pairs: tuple
    packed: np.ndarray


def permute_prepare(perm, n: int) -> PermutePlan:
    """The tile layout of the permute kernel for the qubit map ``perm``
    (length n, an involution: qubit q's value moves to qubit perm[q])."""
    perm = tuple(int(p) for p in perm)
    if sorted(perm) != list(range(n)) or any(perm[p] != q for q, p in enumerate(perm)):
        raise ValueError(f"permute: {perm} is not an involution of the {n} qubits")
    sigma = tuple(n - 1 - perm[n - 1 - p] for p in range(n))
    cols = min(_PERMUTE_COL_BITS, n)
    tile = set(range(cols)) | {sigma[p] for p in range(cols)}
    for p in range(cols, n):
        if p in tile:
            continue
        if sigma[p] == p and len(tile) < _PERMUTE_TILE_BITS:
            tile.add(p)
        elif sigma[p] != p and len(tile) + 2 <= _PERMUTE_TILE_BITS:
            tile |= {p, sigma[p]}
    tile = tuple(sorted(tile))
    rows = tile[cols:]
    stride = (1 << cols) + 1

    def offset(p):  # the shared-memory offset of tile bit p within a tile
        return 1 << p if p < cols else stride << rows.index(p)

    wcol = tuple(offset(sigma[j]) for j in range(cols))
    wrow = tuple(offset(sigma[p]) for p in rows)
    pairs = tuple((p, sigma[p]) for p in range(n) if p not in tile and p < sigma[p])
    if len(pairs) > _PERMUTE_MAX_PAIRS:
        raise ValueError(f"permute: {len(pairs)} swapped pairs outside the tile "
                         f"(at most {_PERMUTE_MAX_PAIRS})")
    row_max = _PERMUTE_TILE_BITS - _PERMUTE_COL_BITS

    def pad(xs, size):
        return list(xs) + [0] * (size - len(xs))

    packed = np.array([cols, len(rows), len(tile), len(pairs)]
                      + pad(tile, _PERMUTE_TILE_BITS) + pad(rows, row_max)
                      + pad(wcol, _PERMUTE_COL_BITS) + pad(wrow, row_max)
                      + pad([a for a, _ in pairs], _PERMUTE_MAX_PAIRS)
                      + pad([b for _, b in pairs], _PERMUTE_MAX_PAIRS), dtype=np.int32)
    return PermutePlan(perm, sigma, cols, tile, rows, wcol, wrow, pairs, packed)


def permute_plain(state: torch.Tensor, perm, n: int) -> torch.Tensor:
    """Qubit q's value moves to qubit perm[q] (``perm`` an involution or a
    :class:`PermutePlan`): each pair of qubits it exchanges is swapped in
    turn, as two axes of a view of at most five (a CUDA copy takes at most
    25 axes that do not merge, fewer than a reversed 30-qubit state has)."""
    if not isinstance(perm, PermutePlan):
        perm = permute_prepare(perm, n)
    for q, p in enumerate(perm.perm):
        if q < p:
            v = state.view(1 << q, 2, 1 << (p - q - 1), 2, 1 << (n - 1 - p))
            v.copy_(v.permute(0, 3, 2, 1, 4).contiguous())
    return state


def permute(state: torch.Tensor, perm, n: int) -> torch.Tensor:
    """Qubit q's value moves to qubit perm[q], for an involution ``perm``
    over all n qubits (a qubit map or a :class:`PermutePlan`), in one pass
    in place."""
    plan = perm if isinstance(perm, PermutePlan) else permute_prepare(perm, n)
    if len(plan.perm) != n:
        raise ValueError(f"permute: a map of {len(plan.perm)} qubits on a {n}-qubit state")
    _check_state(state, n)
    if state.device.type == "cpu":
        return permute_plain(state, plan, n)
    _check_aligned("permute", state)
    return _launch(state, "permute", lambda lib, d, s: lib.qk_permute(
        _ptr(state), n, _host(plan.packed), d, s))


# ---------------------------------------------------------------------------
# The sums of a pair of states (ops.measure.pauli_pair_sums)
# ---------------------------------------------------------------------------


def pair_sums_plain(a: torch.Tensor, b: torch.Tensor, f: int, zs, out: torch.Tensor,
                    n: int) -> torch.Tensor:
    """:func:`pair_sums` by the chunk walk of :mod:`.measure`, on any device."""
    from .measure import pair_walk

    return out.add_(to_device(pair_walk(a, b, n, f, zs), out.device))


def pair_sums(a: torch.Tensor, b: torch.Tensor, f: int, zs, out: torch.Tensor,
              n: int) -> torch.Tensor:
    """Add ``sum_x conj(b[x ^ f]) (-1)^popcount(x & z) a[x]`` for each sign
    mask z of ``zs`` into ``out``, a float64 (len(zs), 2) tensor of real and
    imaginary parts on the states' device, in one pass over ``a`` and ``b``
    (``b`` may be ``a``). Returns ``out``. Unlike the other wrappers it
    reads the states and writes only ``out``; the order of its float64
    additions on the card is not fixed."""
    _check_state(a, n)
    _check_state(b, n)
    zs = np.ascontiguousarray([int(z) for z in zs], dtype=np.int64)
    k = len(zs)
    if b.device != a.device:
        raise ValueError(f"pair_sums: the states lie on {a.device} and {b.device}")
    if (out.device != a.device or out.dtype != torch.float64 or not out.is_contiguous()
            or tuple(out.shape) != (k, 2)):
        raise ValueError(f"pair_sums: out must be a contiguous float64 ({k}, 2) tensor on "
                         f"{a.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    if not (k >= 1 and 0 <= f < 1 << n and all(0 <= z < 1 << n for z in zs)):
        raise ValueError(f"pair_sums: masks must lie in [0, 2^{n}), with at least one sign mask")
    if a.device.type == "cpu":
        return pair_sums_plain(a, b, f, zs, out, n)
    return _launch(out, "pair", lambda lib, d, s: lib.qk_pair_sums(
        _ptr(a), _ptr(b), n, f, k, _host(zs), _ptr(out), d, s))


#: kernel name -> (wrapper, plain version); both take (state, *operands, n),
#: except the butterfly's, which take (banks, plan, m)
KERNEL_FNS = {
    "gate": (gate, gate_plain),
    "diag": (diag, diag_plain),
    "lane": (lane, lane_plain),
    "layer1q": (layer1q, layer1q_plain),
    "stage": (stage_block, stage_block_plain),
    "butterfly": (shard_butterfly, shard_butterfly_plain),
    "permute": (permute, permute_plain),
}
