"""State tensors and the plain gate appliers.

A state is ONE contiguous ``torch.complex64`` tensor of length 2^n on
``config.device``. Qubit-index convention (matches the reference,
src/Qubism/StateVec.hs:65-67): **big-endian** — qubit q is bit n-1-q of the
amplitude index, and targets[0] is the most significant bit of a gate's
local index.

:func:`state_from_planes` / :func:`planes_from_state` convert to and from
the JAX package's (re, im) float32 planes (flat or canonical (R, 2048)), so
tests can feed one state to both packages. A vectorized density matrix
(core/density.py) crosses through the same pair unchanged: both packages
keep rho's row index in the top n qubits of a 2n-qubit state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config
from ..utils import profiling

#: log2 of the lane block: the last _COL qubits form the rows that the lane
#: kernel (ops/kernels.py:lane) multiplies by one dense 128x128 matrix.
_COL = 7


def canonical_device(dev) -> torch.device:
    """A torch device with its index filled in (``cuda`` -> ``cuda:<current>``),
    so that it compares equal to the device of a tensor made on it."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device() -> torch.device:
    """``config.device`` as a torch device; raises when it names CUDA and
    no CUDA device is present (the port never falls back to the CPU)."""
    dev = torch.device(config.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"config.device is {config.device!r} but torch.cuda.is_available() "
            f"is False; set QUBISM_TORCH_DEVICE=cpu to run on the CPU")
    return canonical_device(dev)


# ---------------------------------------------------------------------------
# Host boundary
# ---------------------------------------------------------------------------


def state_from_planes(re, im) -> torch.Tensor:
    """(re, im) float planes of any shape totalling 2^n (flat or the JAX
    package's canonical (R, 2048)) -> a flat complex64 tensor on the
    configured device."""
    re = np.asarray(re, dtype=np.float32).reshape(-1)
    im = np.asarray(im, dtype=np.float32).reshape(-1)
    z = (re.astype(np.complex64) + 1j * im.astype(np.complex64)).astype(np.complex64)
    return torch.from_numpy(z).to(device())


def planes_from_state(t: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """A state tensor -> flat (re, im) float32 numpy planes on the host."""
    z = t.detach().reshape(-1).cpu().numpy()
    return z.real.astype(np.float32), z.imag.astype(np.float32)


def complex_from_state(t: torch.Tensor) -> np.ndarray:
    """A state tensor -> host numpy complex128 amplitudes."""
    return t.detach().reshape(-1).cpu().numpy().astype(np.complex128)


def to_device(a: np.ndarray, dev) -> torch.Tensor:
    """The host array ``a`` as a tensor on ``dev``. To a device other than
    the CPU it is a copy from pageable memory, which PyTorch makes
    synchronously (an async copy, then a wait for the stream): it counts
    under ``syncs`` and runs in a ``qubism.sync`` span. On the CPU the
    tensor shares ``a``'s memory and counts nothing."""
    if torch.device(dev).type == "cpu":
        return torch.from_numpy(a)
    profiling.count("syncs")
    with profiling.span("qubism.sync"):
        return torch.from_numpy(a).to(dev)


def to_host(t: torch.Tensor) -> np.ndarray:
    """The tensor ``t`` as a host numpy array. From a device other than the
    CPU it is a synchronous copy, which waits for the work queued before
    it: it counts under ``syncs`` and runs in a ``qubism.sync`` span. A CPU
    tensor's array shares its memory and counts nothing."""
    if t.device.type == "cpu":
        return t.numpy()
    profiling.count("syncs")
    with profiling.span("qubism.sync"):
        return t.cpu().numpy()


_ONE = np.ones(1, dtype=np.complex64)


def zero_state(n: int) -> torch.Tensor:
    """|0...0> on n qubits."""
    s = torch.zeros(1 << n, dtype=torch.complex64, device=device())
    s[:1].copy_(to_device(_ONE, s.device))
    return s


def as_operand(a, like: torch.Tensor) -> torch.Tensor:
    """A host numpy complex array (or a tensor) as a complex64 tensor on
    ``like``'s device."""
    if isinstance(a, torch.Tensor):
        return a.to(device=like.device, dtype=torch.complex64)
    return to_device(np.ascontiguousarray(a, dtype=np.complex64), like.device)


# ---------------------------------------------------------------------------
# Host-side matrix helpers
# ---------------------------------------------------------------------------


def _expand_np(u: np.ndarray, src: tuple[int, ...], dst: tuple[int, ...]) -> np.ndarray:
    """Expand a gate on qubit set ``src`` (matrix bit order) to the superset
    ``dst`` by tensoring identities, host-side."""
    m, k = len(dst), len(src)
    if m == k and tuple(src) == tuple(dst):
        return u
    extra = [q for q in dst if q not in src]
    cur = list(src) + extra
    perm = [cur.index(q) for q in dst]
    full = np.kron(u, np.eye(1 << (m - k), dtype=u.dtype))
    return (
        full.reshape((2,) * (2 * m))
        .transpose(perm + [m + p for p in perm])
        .reshape(1 << m, 1 << m)
    )


def expand_for_view(u: np.ndarray, n: int, targets: tuple[int, ...]) -> np.ndarray:
    """Expand a gate on sorted ``targets`` that all lie in the lane block
    (the last 7 qubits) to the whole lane block: a (2^min(n,7),)^2 matrix
    for :func:`ops.kernels.lane`."""
    b = max(n - _COL, 0)
    if any(t < b for t in targets):
        raise ValueError(f"targets {targets} leave the lane block of n={n}")
    return _expand_np(u, tuple(targets), tuple(range(b, n)))


def _sort_targets(u: np.ndarray, targets: tuple[int, ...]) -> tuple[np.ndarray, tuple[int, ...]]:
    """Host-side: reorder a (2^k, 2^k) gate matrix from its given target
    order to sorted order. Row/column index bit j (MSB-first) corresponds to
    targets[j]."""
    k = len(targets)
    order = tuple(sorted(range(k), key=lambda j: targets[j]))
    if order != tuple(range(k)):
        u = (
            u.reshape((2,) * (2 * k))
            .transpose(tuple(order) + tuple(k + j for j in order))
            .reshape(1 << k, 1 << k)
        )
    return u, tuple(sorted(targets))


def target_view(n: int, targets: tuple[int, ...]):
    """Minimal-rank view of a 2^n state exposing each sorted target as a
    size-2 axis: (dims, axis of each target). Rank <= 2k+1, so a view never
    reaches torch's per-kernel dimension limits at large n."""
    dims: list[int] = []
    axes: list[int] = []
    prev = 0
    for t in targets:
        if t > prev:
            dims.append(1 << (t - prev))
        axes.append(len(dims))
        dims.append(2)
        prev = t + 1
    if n > prev:
        dims.append(1 << (n - prev))
    return dims, axes


# ---------------------------------------------------------------------------
# Appliers: one gate or diagonal at a time, through the kernel wrappers
# ---------------------------------------------------------------------------


def apply_gate(state: torch.Tensor, u, targets: tuple[int, ...], n: int) -> torch.Tensor:
    """Apply a k-qubit unitary ``u`` (host complex (2^k, 2^k), targets in
    any order, targets[0] = MSB) to ``state`` in place; returns ``state``.

    Targets that all lie in the lane block go to ``kernels.lane``, other
    gates on up to 4 targets to ``kernels.gate`` (each launches its kernel
    on a CUDA state and runs its plain version on a CPU one). A dense gate
    on more than 4 targets that leaves the lane block has no kernel and runs
    as ``kernels.gate_plain``, as the JAX package leaves it to XLA."""
    from . import kernels

    un, sorted_targets = _sort_targets(np.asarray(u, dtype=np.complex128),
                                       tuple(int(t) for t in targets))
    b = max(n - _COL, 0)
    if all(t >= b for t in sorted_targets):
        return kernels.lane(state, expand_for_view(un, n, sorted_targets), n)
    if len(sorted_targets) <= 4:
        return kernels.gate(state, un, sorted_targets, n)
    return kernels.gate_plain(state, un, sorted_targets, n)


def apply_diag(state: torch.Tensor, d, targets: tuple[int, ...], n: int) -> torch.Tensor:
    """Multiply ``state`` in place by the diagonal k-qubit gate whose
    diagonal is ``d`` (2^k,), through ``kernels.diag``; returns ``state``."""
    from . import kernels

    return kernels.diag(state, ((np.asarray(d, dtype=np.complex128),
                                 tuple(int(t) for t in targets)),), n)


def tensor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ⊗ b: the first operand's qubits become the most significant index
    bits (reference ``tensor``, src/Qubism/StateVec.hs:98-100)."""
    return torch.outer(a, b).reshape(-1)


def normalize(state: torch.Tensor) -> torch.Tensor:
    """L2-normalized copy."""
    nrm = torch.linalg.vector_norm(state)
    return state / torch.where(nrm == 0, torch.ones_like(nrm), nrm)
