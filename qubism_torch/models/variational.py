"""Differentiable variational circuits: VQE and QAOA by torch.autograd and
by the adjoint method.

Counterpart of qubism_tpu/models/variational.py (its state-vector part).
Parameterized gate matrices are built from a ``theta`` vector, the state is
evolved op by op, and a Pauli-sum energy is reduced from it:

* **autodiff** (:func:`state_fn`, :func:`energy_fn`,
  :func:`value_and_grad_fn`, ``vqe_minimize(grad="auto")``): the gates are
  applied by out-of-place torch functions (the kernel wrappers update a
  state in place, which autograd cannot differentiate), and ``backward``
  takes the place of ``jax.value_and_grad``. It keeps one state per gate,
  so it is the path for small n.
* **adjoint** (:func:`adjoint_value_and_grad_fn`,
  ``vqe_minimize(grad="adjoint")``): one forward sweep, then a reverse
  sweep that un-applies each gate from phi = psi and lam = H psi and
  contracts each parameter's gradient, holding ~2 states at any depth.
  ``engine="plain"`` (the counterpart of the JAX ``"xla"`` engine) runs the
  sweep with the same torch functions; ``engine="kernels"``
  (:mod:`.adjoint_engine`) runs it through the CUDA kernels; ``"auto"``
  picks the kernels at n >= 14 when every op has a kernel lowering.

Parameters are real float32. A gate's ``pidx`` names positions in
``theta``, so QAOA's per-layer (gamma, beta) pairs drive every edge and
qubit of the layer from two scalars. Each builder is written once and
evaluated either in float64 numpy (:data:`BUILDERS`, for :func:`bind` and
the adjoint engines' operands) or on 0-d torch tensors
(:data:`TORCH_BUILDERS`, for autograd); both give the same matrices.

``mesh=`` (a sequence of torch devices, ``parallel.make_mesh``) shards the
state's amplitudes over D = 2^d devices, the top d qubits selecting the
shard (the JAX package's ``shard_map`` block layout, ``ShardedSim`` with no
banks). The plain appliers, energies and the plain adjoint sweep run on
the tuple of shards (one device is the 1-tuple), an op on device-bit
targets combining the partner shards it mixes; the adjoint's kernel engine
on a mesh is :mod:`.adjoint_mesh`.
"""

from __future__ import annotations

import functools
import math
import operator
from dataclasses import dataclass

import numpy as np
import torch

from ..core.gates import Prim
from ..ops import apply as A
from ..ops import measure as M

# ---------------------------------------------------------------------------
# Parameterized gate builders, written once for numpy and for torch
# ---------------------------------------------------------------------------


class _Numpy:
    """Scalar ops on Python floats (float64)."""

    cos = staticmethod(math.cos)
    sin = staticmethod(math.sin)

    @staticmethod
    def z(x):
        return 0.0

    @staticmethod
    def o(x):
        return 1.0


class _Torch:
    """Scalar ops on 0-d real tensors (differentiable)."""

    cos = staticmethod(torch.cos)
    sin = staticmethod(torch.sin)

    @staticmethod
    def z(x):
        return torch.zeros_like(x)

    @staticmethod
    def o(x):
        return torch.ones_like(x)


def _rx(xp, t):
    c, s = xp.cos(t / 2), xp.sin(t / 2)
    z = xp.z(t)
    return "dense", [[c, z], [z, c]], [[z, -s], [-s, z]]


def _ry(xp, t):
    c, s = xp.cos(t / 2), xp.sin(t / 2)
    z = xp.z(t)
    return "dense", [[c, -s], [s, c]], [[z, z], [z, z]]


def _rz(xp, t):
    c, s = xp.cos(t / 2), xp.sin(t / 2)
    return "diag", [c, c], [-s, s]


def _phase(xp, lam):
    return "diag", [xp.o(lam), xp.cos(lam)], [xp.z(lam), xp.sin(lam)]


def _u3(xp, t, p, l):
    ct, st = xp.cos(t / 2), xp.sin(t / 2)
    re = [[ct, -xp.cos(l) * st], [xp.cos(p) * st, xp.cos(p + l) * ct]]
    im = [[xp.z(ct), -xp.sin(l) * st], [xp.sin(p) * st, xp.sin(p + l) * ct]]
    return "dense", re, im


def _cphase(xp, lam):
    one, zero = xp.o(lam), xp.z(lam)
    return "diag", [one, one, one, xp.cos(lam)], [zero, zero, zero, xp.sin(lam)]


def _crz(xp, lam):
    c, s = xp.cos(lam / 2), xp.sin(lam / 2)
    one, zero = xp.o(lam), xp.z(lam)
    return "diag", [one, one, c, c], [zero, zero, -s, s]


def _rzz(xp, t):
    # exp(-i t/2 Z (x) Z): diag(e^{-it/2}, e^{it/2}, e^{it/2}, e^{-it/2})
    c, s = xp.cos(t / 2), xp.sin(t / 2)
    return "diag", [c, c, c, c], [-s, s, s, -s]


def _cry(xp, t):
    c, s = xp.cos(t / 2), xp.sin(t / 2)
    o, z = xp.o(t), xp.z(t)
    re = [[o, z, z, z], [z, o, z, z], [z, z, c, -s], [z, z, s, c]]
    return "dense", re, [[z] * 4 for _ in range(4)]


def _crx(xp, t):
    c, s = xp.cos(t / 2), xp.sin(t / 2)
    o, z = xp.o(t), xp.z(t)
    re = [[o, z, z, z], [z, o, z, z], [z, z, c, z], [z, z, z, c]]
    im = [[z, z, z, z], [z, z, z, z], [z, z, z, -s], [z, z, -s, z]]
    return "dense", re, im


def _rxx(xp, t):
    # exp(-i t/2 X(x)X) = cos(t/2) I - i sin(t/2) XX
    c, s = xp.cos(t / 2), xp.sin(t / 2)
    z = xp.z(t)
    re = [[c, z, z, z], [z, c, z, z], [z, z, c, z], [z, z, z, c]]
    im = [[z, z, z, -s], [z, z, -s, z], [z, -s, z, z], [-s, z, z, z]]
    return "dense", re, im


def _ryy(xp, t):
    # exp(-i t/2 Y(x)Y) = cos(t/2) I - i sin(t/2) YY  (YY is real)
    c, s = xp.cos(t / 2), xp.sin(t / 2)
    z = xp.z(t)
    re = [[c, z, z, z], [z, c, z, z], [z, z, c, z], [z, z, z, c]]
    im = [[z, z, z, s], [z, z, -s, z], [z, -s, z, z], [s, z, z, z]]
    return "dense", re, im


_DEFS = {"rx": (_rx, 1), "ry": (_ry, 1), "rz": (_rz, 1), "phase": (_phase, 1),
         "u3": (_u3, 3), "cphase": (_cphase, 1), "crz": (_crz, 1), "crx": (_crx, 1),
         "cry": (_cry, 1), "rzz": (_rzz, 1), "rxx": (_rxx, 1), "ryy": (_ryy, 1)}


def _numpy_builder(fn):
    def build(*args):
        kind, re, im = fn(_Numpy, *(float(a) for a in args))
        return kind, np.asarray(re, dtype=np.float64) + 1j * np.asarray(im, dtype=np.float64)

    return build


def _stack(rows):
    if isinstance(rows[0], list):
        return torch.stack([torch.stack(r) for r in rows])
    return torch.stack(rows)


def _torch_builder(fn):
    def build(*args):
        kind, re, im = fn(_Torch, *args)
        return kind, torch.complex(_stack(re), _stack(im))

    return build


#: name -> (builder, arity): the builder takes ``arity`` floats and returns
#: (kind, complex128 numpy matrix (2^k, 2^k) or diagonal (2^k,)),
#: kind "dense" or "diag"
BUILDERS = {name: (_numpy_builder(fn), arity) for name, (fn, arity) in _DEFS.items()}
#: name -> the same builder on 0-d real tensors (complex tensor out)
TORCH_BUILDERS = {name: _torch_builder(fn) for name, (fn, _) in _DEFS.items()}


@dataclass(frozen=True)
class PGate:
    """A parameterized gate: ``BUILDERS[name]`` applied to
    ``theta[pidx[0]], ...`` on ``targets`` (targets[0] = MSB of the gate's
    local index). ``scale`` premultiplies each parameter (so e.g. QAOA's
    ``rx(2*beta)`` shares beta's raw index)."""

    name: str
    targets: tuple[int, ...]
    pidx: tuple[int, ...]
    scale: float = 1.0

    def __post_init__(self):
        if self.name not in BUILDERS:
            raise ValueError(f"unknown parameterized gate {self.name!r}")
        if len(self.pidx) != BUILDERS[self.name][1]:
            raise ValueError(
                f"{self.name} takes {BUILDERS[self.name][1]} parameter(s), "
                f"got indices {self.pidx}")


@dataclass(frozen=True)
class Ansatz:
    """A circuit of fixed :class:`Prim` and parameterized :class:`PGate`
    ops on ``n`` qubits, driven by a flat ``theta`` of ``num_params``."""

    n: int
    ops: tuple
    num_params: int

    def __post_init__(self):
        for op in self.ops:
            hi = max(op.targets)
            if hi >= self.n:
                raise ValueError(f"target {hi} out of range for n={self.n}")
            if isinstance(op, PGate) and max(op.pidx) >= self.num_params:
                raise ValueError(f"param index {max(op.pidx)} out of range "
                                 f"for num_params={self.num_params}")


# ---------------------------------------------------------------------------
# Out-of-place appliers (differentiable torch ops)
# ---------------------------------------------------------------------------


def _layout(mesh, n: int):
    """(devices, d, m) of the amplitude layout: ``mesh`` a sequence of torch
    devices (``parallel.make_mesh``; a device may repeat) holds D = 2^d
    shards of m = n - d qubits, shard i on ``mesh[i]`` with the amplitudes
    whose top d qubits read i (qubit q < d is bit d-1-q of i). ``None`` is
    one shard on ``config.device``."""
    if mesh is None:
        return (A.device(),), 0, n
    if isinstance(mesh, int):
        raise TypeError(f"mesh must be a sequence of torch devices, as "
                        f"parallel.make_mesh({mesh}) gives, not the int {mesh}")
    devices = tuple(A.canonical_device(dv) for dv in mesh)
    d = len(devices).bit_length() - 1
    if not devices or (1 << d) != len(devices):
        raise ValueError(f"mesh size {len(devices)} is not a power of two")
    if n < d:
        raise ValueError(f"need at least {d} qubits for {len(devices)} shards")
    return devices, d, n - d


def _zero_shards(devices, m: int) -> tuple:
    """|0...0> as one complex64 shard of 2^m amplitudes per device."""
    shards = tuple(torch.zeros(1 << m, dtype=torch.complex64, device=dv) for dv in devices)
    shards[0][0] = 1
    return shards


def _peer(shards, i: int, j: int) -> torch.Tensor:
    """Shard j as an operand of shard i's update, on shard i's device (a
    peer copy when the two differ). Every read of one shard by another's
    update goes through here."""
    return shards[j].to(shards[i].device)


def _field(i: int, qubits, d: int) -> int:
    """The bits of shard index i at the device qubits ``qubits``, MSB
    first."""
    out = 0
    for q in qubits:
        out = (out << 1) | ((i >> (d - 1 - q)) & 1)
    return out


def _parity_signs(i: int, masks) -> np.ndarray:
    """(-1)^popcount(i & mask) for each mask, float64."""
    return np.array([1.0 - 2.0 * (bin(i & mk).count("1") & 1) for mk in masks])


def _host_theta(theta) -> np.ndarray:
    """theta as float64 values of its float32 entries, on the host."""
    if isinstance(theta, torch.Tensor):
        theta = theta.detach().cpu().numpy()
    return np.asarray(theta, dtype=np.float32).astype(np.float64)


def _sort_matrix(u: torch.Tensor, targets):
    """A (2^k, 2^k) operand reordered from the given target order to sorted
    order, and the sorted targets."""
    k = len(targets)
    order = sorted(range(k), key=lambda j: targets[j])
    if order != list(range(k)):
        u = (u.reshape((2,) * (2 * k)).permute(order + [k + j for j in order])
             .reshape(1 << k, 1 << k))
    return u, tuple(sorted(targets))


def _apply_dense(state: torch.Tensor, u: torch.Tensor, targets, n: int) -> torch.Tensor:
    """U (complex (2^k, 2^k), sorted ``targets``, targets[0] = MSB) times the
    state, as a new tensor: the target axes moved last, one matmul, moved
    back."""
    k = len(targets)
    dims, axes = A.target_view(n, targets)
    rest = [a for a in range(len(dims)) if a not in axes]
    perm = rest + axes
    y = state.view(dims).permute(perm).reshape(-1, 1 << k) @ u.T
    inv = [perm.index(a) for a in range(len(dims))]
    return y.view([dims[a] for a in perm]).permute(inv).reshape(-1)


def _apply_diag(state: torch.Tensor, d: torch.Tensor, targets, n: int) -> torch.Tensor:
    """The diagonal ``d`` (2^k,) on ``targets`` (any order) times the state,
    as a new tensor: one broadcast multiply over the target axes."""
    k = len(targets)
    order = sorted(range(k), key=lambda j: targets[j])
    table = d.reshape((2,) * k).permute(order) if k else d
    dims, axes = A.target_view(n, tuple(sorted(targets)))
    shape = [1] * len(dims)
    for a in axes:
        shape[a] = 2
    return (state.view(dims) * table.reshape(shape)).reshape(-1)


def _op_matrix(op, theta, dag: bool = False):
    """(kind, operand) of an op at ``theta``: a torch tensor ``theta`` gives
    a differentiable operand from :data:`TORCH_BUILDERS`, a numpy one a
    constant from :data:`BUILDERS`. ``dag`` gives U^dag."""
    if isinstance(op, PGate):
        args = [op.scale * theta[j] for j in op.pidx]
        if isinstance(theta, torch.Tensor):
            kind, u = TORCH_BUILDERS[op.name](*args)
        else:
            kind, u = BUILDERS[op.name][0](*args)
    else:
        kind, u = ("diag" if op.diag else "dense"), np.asarray(op.u, dtype=np.complex128)
    if dag:
        u = u.conj() if kind == "diag" else u.conj().T
    return kind, u


def _apply_kind(state, kind: str, u, targets, n: int) -> torch.Tensor:
    if not isinstance(u, torch.Tensor):
        u = A.as_operand(u, state)
    u = u.to(device=state.device, dtype=state.dtype)
    if kind == "diag":
        return _apply_diag(state, u, targets, n)
    u, srt = _sort_matrix(u, targets)
    return _apply_dense(state, u, srt, n)


def _permuted(u, perm):
    return u.permute(perm) if isinstance(u, torch.Tensor) else u.transpose(perm)


def _apply_kind_mesh(shards, kind: str, u, targets, n: int, d: int) -> tuple:
    """``(kind, u)`` on ``targets`` applied to the shards of an n-qubit
    state with d device bits, out of place. An op on local targets runs on
    every shard. A diagonal picks each shard's sub-table by the shard's
    device bits (no other shard is read). A dense op with g device-bit
    targets is a block decomposition over them: ``out_a = sum_b U[a, b]``
    applied on the local targets of the shard whose device bits read b,
    the other bits being shard a's; a constant block that is zero is
    skipped and one that is the identity is a copy."""
    m = n - d
    k = len(targets)
    gsel = [j for j in range(k) if targets[j] < d]
    if not gsel:
        local = tuple(t - d for t in targets)
        return tuple(_apply_kind(x, kind, u, local, m) for x in shards)
    lsel = [j for j in range(k) if targets[j] >= d]
    gq = [targets[j] for j in gsel]
    local = tuple(targets[j] - d for j in lsel)
    g, kl = len(gsel), len(lsel)
    order = gsel + lsel
    if kind == "diag":
        tab = _permuted(u.reshape((2,) * k), order).reshape(1 << g, 1 << kl)
        return tuple(_apply_kind(x, "diag", tab[_field(i, gq, d)], local, m)
                     for i, x in enumerate(shards))
    blocks = _permuted(u.reshape((2,) * (2 * k)), order + [k + j for j in order]).reshape(
        1 << g, 1 << kl, 1 << g, 1 << kl)
    masks = [1 << (d - 1 - q) for q in gq]
    eye = np.eye(1 << kl)
    out = []
    for i in range(len(shards)):
        a = _field(i, gq, d)
        base = i & ~sum(masks)
        acc = None
        for b in range(1 << g):
            j = base | sum(mk for r, mk in enumerate(masks) if (b >> (g - 1 - r)) & 1)
            blk = blocks[a, :, b, :]
            if isinstance(blk, np.ndarray) and not blk.any():
                continue
            term = _peer(shards, i, j)
            if not (isinstance(blk, np.ndarray) and np.array_equal(blk, eye)):
                term = _apply_kind(term, "dense", blk, local, m)
            acc = term if acc is None else acc + term
        out.append(acc)
    return tuple(out)


def _apply_op(shards, op, theta, n: int, d: int, dag: bool = False) -> tuple:
    """One op (or its dagger) applied to the shards of a state (a 1-tuple
    and d = 0 on one device), out of place."""
    kind, u = _op_matrix(op, theta, dag)
    return _apply_kind_mesh(shards, kind, u, op.targets, n, d)


# ---------------------------------------------------------------------------
# Energy / gradient / optimization
# ---------------------------------------------------------------------------


def _flip(state: torch.Tensor, f: int, n: int) -> torch.Tensor:
    """state[x ^ f] as a new tensor: a flip of each flipped qubit's axis."""
    qubits = tuple(q for q in range(n) if (f >> (n - 1 - q)) & 1)
    if not qubits:
        return state
    dims, axes = A.target_view(n, qubits)
    return state.view(dims).flip(axes).reshape(-1)


def _sign_sums(t: torch.Tensor, n: int, zs) -> torch.Tensor:
    """sum_x t[x] (-1)^popcount(x & z) for each sign mask z of ``zs``: ``t``
    summed down to the qubits of the masks' union, then one signed sum of
    that small table per mask (a complex tensor of len(zs))."""
    union = functools.reduce(operator.or_, zs, 0)
    qubits = tuple(q for q in range(n) if (union >> (n - 1 - q)) & 1)
    dims, axes = A.target_view(n, qubits)
    drop = [a for a in range(len(dims)) if a not in axes]
    r = t.view(dims).sum(dim=drop) if drop else t.view(dims)
    k = len(qubits)
    idx = np.arange(1 << k, dtype=np.int64)
    # bit k-1-i of the table index is qubits[i] (bit n-1-qubits[i] of x)
    local = [sum(1 << (k - 1 - i) for i, q in enumerate(qubits) if (z >> (n - 1 - q)) & 1)
             for z in zs]
    signs = np.stack([M._parity_sign(idx, m) for m in local])
    return torch.from_numpy(signs).to(device=t.device, dtype=t.dtype) @ r.reshape(-1)


def _terms_energy(shards, n: int, d: int, terms, paulis) -> torch.Tensor:
    """Differentiable <psi| sum_j c_j P_j |psi> (a real 0-d tensor on the
    first shard's device) of a sharded state (a 1-tuple and d = 0 on one
    device). Terms are grouped by flip mask f: per shard i, t(x) =
    conj(psi[x ^ f]) psi[x] is formed once per group from shard i and its
    partner i ^ (f's device bits), each term is a signed sum of t (the
    sign of its device bits a factor per shard), the shards' sums are
    added, and the result is taken times i^{#Y}."""
    m = n - d
    low = (1 << m) - 1
    dev = shards[0].device
    e = torch.zeros((), dtype=torch.float32, device=dev)
    for f, idxs in M.group_terms(paulis).items():
        zs = [M.pauli_masks(paulis[j])[1] for j in idxs]
        vals = 0
        for i, x in enumerate(shards):
            t = _flip(_peer(shards, i, i ^ (f >> m)), f & low, m).conj() * x
            v = _sign_sums(t, m, [z & low for z in zs])
            if d:
                v = v * torch.from_numpy(_parity_signs(i, [z >> m for z in zs])).to(v)
            vals = vals + v.to(dev)
        for pos, j in enumerate(idxs):
            v = vals[pos]
            k_y = paulis[j].count("Y") % 4
            val = (v.real, -v.imag, -v.real, v.imag)[k_y]
            e = e + float(terms[j][0]) * val
    return e


def _check_terms(terms, n: int):
    paulis = tuple(M._check_pauli(p, n) for _, p in terms)
    return paulis, tuple((float(c), p) for (c, _), p in zip(terms, paulis))


def _device_theta(theta) -> torch.Tensor:
    """theta as a float32 tensor on the state's device; a tensor keeps its
    autograd graph."""
    dev = A.device()
    if isinstance(theta, torch.Tensor):
        return theta.to(device=dev, dtype=torch.float32)
    return torch.from_numpy(np.asarray(theta, dtype=np.float32)).to(dev)


def _sharded_state_fn(ansatz: Ansatz, mesh):
    """``theta -> (shards, d)`` of :func:`state_fn` (one shard without a
    mesh)."""
    n = ansatz.n

    def run(theta):
        devices, d, m = _layout(mesh, n)
        theta = _device_theta(theta)
        shards = _zero_shards(devices, m)
        for op in ansatz.ops:
            shards = _apply_op(shards, op, theta, n, d)
        return shards, d

    _layout(mesh, n)  # refuse a bad mesh when the function is made
    return run


def state_fn(ansatz: Ansatz, mesh=None):
    """``theta -> state``: the differentiable state preparation, a complex64
    tensor of 2^n amplitudes on ``config.device`` (``theta`` a float32
    tensor, which may require grad, or an array).

    ``mesh`` (a sequence of torch devices, ``parallel.make_mesh``; a device
    may repeat) shards the state's amplitudes over D = 2^d devices for the
    whole pipeline: ``theta -> (shard_0, ..., shard_{D-1})``, shard i a
    complex64 tensor of 2^(n-d) amplitudes on ``mesh[i]`` holding those
    whose top d qubits read i, so ``torch.cat`` of the shards on one device
    is the state. An op on device-bit targets reads only the partner
    shards it mixes; autograd follows the copies between devices."""
    run = _sharded_state_fn(ansatz, mesh)

    def state(theta):
        shards, _ = run(theta)
        return shards if mesh is not None else shards[0]

    return state


def energy_fn(ansatz: Ansatz, terms, constant: float = 0.0, mesh=None):
    """``theta -> <psi(theta)| sum_j c_j P_j |psi(theta)> + constant`` as a
    differentiable 0-d float32 tensor. ``terms`` = [(coef, pauli), ...].
    ``mesh`` shards the state (see :func:`state_fn`)."""
    paulis, _ = _check_terms(terms, ansatz.n)
    run = _sharded_state_fn(ansatz, mesh)

    def energy(theta):
        shards, d = run(theta)
        return _terms_energy(shards, ansatz.n, d, terms, paulis) + float(constant)

    return energy


def _leaf(theta) -> torch.Tensor:
    """A fresh CPU float32 leaf tensor of theta's values, requiring grad."""
    return torch.from_numpy(_host_theta(theta).astype(np.float32)).requires_grad_(True)


def value_and_grad_fn(ansatz: Ansatz, terms, constant: float = 0.0, mesh=None):
    """``theta -> (energy, dE/dtheta)`` by reverse-mode autodiff: a 0-d
    float32 tensor and a float32 tensor of ``num_params``, both on the
    CPU (the counterpart of ``jax.value_and_grad`` of :func:`energy_fn`)."""
    efn = energy_fn(ansatz, terms, constant, mesh=mesh)

    def vg(theta):
        th = _leaf(theta)
        e = efn(th)
        (g,) = torch.autograd.grad(e, th)
        return e.detach().cpu(), g

    return vg


def vqe_minimize(ansatz: Ansatz, terms, theta0, steps: int = 200,
                 optimizer=None, constant: float = 0.0,
                 grad: str = "auto", scan: bool = True,
                 segment_size: int | None = None, mesh=None):
    """Gradient-descent VQE: ``steps`` iterations of value-and-gradient and
    an optimizer step on a CPU float32 ``theta``.

    ``grad="auto"`` uses reverse-mode autodiff (one state per gate: small
    n); ``grad="adjoint"`` the adjoint sweep of
    :func:`adjoint_value_and_grad_fn` (~2 states at any depth; the kernel
    engine at n >= 14). ``optimizer`` is a callable ``params ->
    torch.optim.Optimizer``; the default ``torch.optim.Adam(params,
    lr=0.1)`` makes the same update as the JAX package's ``optax.adam(0.1)``
    (bias-corrected moments, eps outside the square root).

    ``scan`` and ``segment_size`` are the JAX package's compile controls
    (one ``lax.scan`` program, bounded jitted segments). Eager torch has no
    such program: they are accepted and change nothing.

    Returns ``(theta_opt, energies)``, float32 CPU tensors, with
    ``energies[i]`` the energy at step i's parameters (before that step's
    update)."""
    del scan
    if grad == "adjoint":
        vg = adjoint_value_and_grad_fn(ansatz, terms, constant,
                                       segment_size=segment_size, mesh=mesh)
    elif grad == "auto":
        vg = value_and_grad_fn(ansatz, terms, constant, mesh=mesh)
    else:
        raise ValueError(f"grad must be 'auto' or 'adjoint', got {grad!r}")
    theta = _leaf(theta0)
    opt = (optimizer if optimizer is not None
           else lambda params: torch.optim.Adam(params, lr=0.1))([theta])
    hist = []
    for _ in range(steps):
        e, g = vg(theta)
        theta.grad = g.detach().to(torch.float32).reshape(theta.shape)
        opt.step()
        hist.append(float(e))
    return theta.detach().clone(), torch.tensor(hist, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Adjoint-method gradients (constant memory in circuit depth)
# ---------------------------------------------------------------------------

#: op kind per builder (dense operand vs diagonal)
_KIND = {name: fn(_Numpy, *([0.0] * arity))[0] for name, (fn, arity) in _DEFS.items()}

#: Pauli generator of each one-parameter builder, as (coef, chars-on-targets)
#: terms with U(t) = e^{i eta(t)} exp(-i t G); the global phase eta drops
#: out of every gradient. Controlled gates expand their projector:
#: P1 (x) A = ((I-Z)/2) (x) A; the I(x)A piece of crz/cphase is itself a
#: Pauli term, not a phase, so it stays.
_GEN = {
    "rx": ((0.5, "X"),), "ry": ((0.5, "Y"),), "rz": ((0.5, "Z"),),
    "rzz": ((0.5, "ZZ"),), "rxx": ((0.5, "XX"),), "ryy": ((0.5, "YY"),),
    "phase": ((0.5, "Z"),),                      # diag(1,e^{il}): G=-(I-Z)/2
    "cphase": ((0.25, "IZ"), (0.25, "ZI"), (-0.25, "ZZ")),   # G = -P1(x)P1
    "crz": ((0.25, "IZ"), (-0.25, "ZZ")),        # G = P1 (x) Z/2
    "crx": ((0.25, "IX"), (-0.25, "ZX")),        # G = P1 (x) X/2
    "cry": ((0.25, "IY"), (-0.25, "ZY")),        # G = P1 (x) Y/2
}


def _gen_terms(op, n: int):
    """``_GEN[op.name]`` expanded to n-qubit Pauli strings on
    ``op.targets`` (targets[0] = first char = MSB of the gate index)."""
    out = []
    for coef, chars in _GEN[op.name]:
        s = ["I"] * n
        for t, ch in zip(op.targets, chars):
            s[t] = ch
        out.append((coef, "".join(s)))
    return tuple(out)


def _builder_jvp(name: str, args, i: int) -> torch.Tensor:
    """d U / d args[i] of a builder at ``args`` (complex128 tensor): the
    exact forward-mode derivative of the small gate matrix."""
    build = TORCH_BUILDERS[name]
    primals = tuple(torch.tensor(float(a), dtype=torch.float64) for a in args)
    tangents = tuple(torch.tensor(1.0 if j == i else 0.0, dtype=torch.float64)
                     for j in range(len(args)))
    _, du = torch.func.jvp(lambda *a: torch.view_as_real(build(*a)[1]), primals, tangents)
    return torch.view_as_complex(du.contiguous())


def _pair_values(a, b, n: int, d: int, paulis) -> np.ndarray:
    """<b|P_j|a> (complex128, i^{#Y} included) for each checked Pauli string
    of two sharded states (1-tuples and d = 0 on one device). Per flip mask
    f, shard i of ``a`` is walked with shard i ^ (f's device bits) of ``b``
    by :func:`ops.measure.pauli_pair_sums` (which reads a partner on another
    device chunk by chunk), each term's device bits give a sign per shard,
    and the sums are added in float64 on the host."""
    m = n - d
    low = (1 << m) - 1
    out = np.zeros(len(paulis), dtype=np.complex128)
    for f, idxs in M.group_terms(paulis).items():
        zs = [M.pauli_masks(paulis[j])[1] for j in idxs]
        for i in range(len(a)):
            sums = M.pauli_pair_sums(a[i], b[i ^ (f >> m)], m, f & low, [z & low for z in zs])
            out[idxs] += sums * _parity_signs(i, [z >> m for z in zs])
    return np.array([M._apply_iy(s.real, s.imag, p.count("Y")) for s, p in zip(out, paulis)])


def _apply_pauli_sum(shards, terms, n: int, d: int) -> tuple:
    """(sum_j c_j P_j)|psi> of a sharded state, as new shards: shard i of
    P|psi> is P's local part applied (:func:`ops.measure.apply_pauli`) to
    the partner shard i ^ (P's device flip bits), times (-i)^{#Y on device
    bits} and the sign of i's device Z/Y bits."""
    m = n - d
    out = [None] * len(shards)
    for coef, pauli in terms:
        f, z, _ = M.pauli_masks(pauli)
        phase = (-1j) ** (pauli[:d].count("Y") % 4)
        for i in range(len(shards)):
            term = M.apply_pauli(_peer(shards, i, i ^ (f >> m)), pauli[d:], m)
            scale = complex(coef * phase * _parity_signs(i, [z >> m])[0])
            out[i] = term.mul_(scale) if out[i] is None else out[i].add_(term, alpha=scale)
    return tuple(torch.zeros_like(x) if y is None else y for x, y in zip(shards, out))


def _vdot(a, b) -> complex:
    """<a|b> of two sharded states, summed over the shards on the host."""
    return sum(complex(torch.vdot(x, y)) for x, y in zip(a, b))


def _adjoint_bwd_step(op, theta: np.ndarray, phi, lam, g: np.ndarray, n: int, d: int):
    """One reverse-sweep step on sharded phi and lam (1-tuples and d = 0 on
    one device): add this op's parameter gradient into ``g`` (float64, on
    the host), then un-apply the op from phi and lam. Returns (phi', lam').

    One-parameter gates are Pauli exponentials U = e^{i eta} exp(-i s
    theta_j G) (:data:`_GEN`), so ``dU/dtheta |psi_before> = -i s G
    |psi_after>`` and the gradient is ``2 s Im <lam|G phi>``: one
    :func:`_apply_pauli_sum` and one inner product. Multi-parameter
    builders (u3) take the dense derivative of the gate
    (:func:`_builder_jvp`)."""
    if isinstance(op, PGate) and op.name in _GEN and len(op.pidx) == 1:
        gphi = _apply_pauli_sum(phi, _gen_terms(op, n), n, d)
        g[op.pidx[0]] += 2.0 * op.scale * _vdot(lam, gphi).imag
        del gphi
        return (_apply_op(phi, op, theta, n, d, dag=True),
                _apply_op(lam, op, theta, n, d, dag=True))
    phi = _apply_op(phi, op, theta, n, d, dag=True)  # psi before this op
    if isinstance(op, PGate):
        args = [op.scale * theta[j] for j in op.pidx]
        for li, j in enumerate(op.pidx):
            du = _builder_jvp(op.name, args, li)
            dphi = _apply_kind_mesh(phi, _KIND[op.name], du, op.targets, n, d)
            g[j] += op.scale * 2.0 * _vdot(lam, dphi).real
    return phi, _apply_op(lam, op, theta, n, d, dag=True)


def adjoint_value_and_grad_fn(ansatz: Ansatz, terms, constant: float = 0.0,
                              segment_size: int | None = None, mesh=None,
                              engine: str = "auto"):
    """``theta -> (energy, dE/dtheta)`` by the ADJOINT method: one forward
    sweep, then a reverse sweep that un-applies each gate and contracts
    ``2 Re <lam| dU/dtheta |psi>``. Memory stays ~2 states plus
    temporaries at any circuit depth (reverse autodiff stores one state per
    gate).

    ``engine``: ``"plain"`` sweeps with the out-of-place torch appliers
    (the JAX ``"xla"`` engine's counterpart); ``"kernels"`` runs the sweep
    through the CUDA kernels in place
    (:func:`.adjoint_engine.kernel_adjoint_value_and_grad_fn`; ValueError
    for an ansatz it cannot lower); ``"auto"`` picks ``"kernels"`` at
    n >= 14 when :func:`.adjoint_engine.supports` the ansatz, as the JAX
    package picks its Pallas engine, and the plain sweep otherwise. The
    callable's ``_engine`` names the engine that runs.

    ``mesh`` (see :func:`state_fn`) shards phi and lam over D devices.
    ``"kernels"`` then runs :func:`.adjoint_mesh.mesh_adjoint_value_and_grad_fn`
    (ValueError for an ansatz or a Hamiltonian it cannot lower: it never
    runs the plain sweep in its place); ``"auto"`` tries it at n >= 14 and
    falls back to the plain sweep on the shards only on that ValueError,
    as the JAX package's router does; ``"plain"`` is the plain sweep on the
    shards (``_engine`` "plain-mesh").

    ``segment_size`` is the JAX package's compile control (bounded jitted
    segments); eager torch has no such program, so it changes nothing.
    Energy and gradient come back as float32 CPU tensors."""
    del segment_size
    n = ansatz.n
    if engine not in ("auto", "plain", "kernels"):
        raise ValueError(f"engine must be auto|plain|kernels, got {engine!r}")
    if engine != "plain" and mesh is not None:
        from .adjoint_mesh import mesh_adjoint_value_and_grad_fn

        if engine == "kernels":
            return mesh_adjoint_value_and_grad_fn(ansatz, terms, mesh, constant)
        if n >= 14:
            try:
                return mesh_adjoint_value_and_grad_fn(ansatz, terms, mesh, constant)
            except ValueError:
                pass
    elif engine != "plain":
        from .adjoint_engine import kernel_adjoint_value_and_grad_fn, supports

        if engine == "kernels" or (n >= 14 and supports(ansatz)):
            return kernel_adjoint_value_and_grad_fn(ansatz, terms, constant)
    paulis, checked = _check_terms(terms, n)
    coefs = np.array([c for c, _ in checked])
    _layout(mesh, n)  # refuse a bad mesh when the function is made

    def vg(theta):
        th = _host_theta(theta)
        devices, d, m = _layout(mesh, n)
        with torch.no_grad():
            phi = _zero_shards(devices, m)
            for op in ansatz.ops:
                phi = _apply_op(phi, op, th, n, d)
            e = float(coefs @ _pair_values(phi, phi, n, d, paulis).real) + float(constant)
            lam = _apply_pauli_sum(phi, checked, n, d)
            g = np.zeros(ansatz.num_params)
            for op in reversed(ansatz.ops):
                phi, lam = _adjoint_bwd_step(op, th, phi, lam, g, n, d)
        return torch.tensor(e, dtype=torch.float32), torch.from_numpy(g.astype(np.float32))

    vg._engine = "plain" if mesh is None else "plain-mesh"
    return vg


# ---------------------------------------------------------------------------
# Ansatz families
# ---------------------------------------------------------------------------


def hea_ansatz(n: int, layers: int) -> Ansatz:
    """Hardware-efficient ansatz: per layer, ry+rz on every qubit followed
    by a CNOT ring; one trailing rotation layer. 2*n*(layers+1) params."""
    cnot = np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1], [0, 0, 1, 0]], dtype=np.complex128)
    ops = []
    p = 0
    for layer in range(layers + 1):
        for q in range(n):
            ops.append(PGate("ry", (q,), (p,)))
            ops.append(PGate("rz", (q,), (p + 1,)))
            p += 2
        if layer < layers and n > 1:
            for q in range(n):
                ops.append(Prim(cnot, (q, (q + 1) % n)))
    return Ansatz(n, tuple(ops), p)


def qaoa_maxcut_ansatz(n: int, edges, p_layers: int) -> Ansatz:
    """Differentiable QAOA MaxCut ansatz matching
    :func:`qubism_torch.models.circuits.qaoa_prims`: theta layout is
    ``[gamma_0..gamma_{p-1}, beta_0..beta_{p-1}]``; the cost layer applies
    ``exp(-i gamma Z_i Z_j)`` (= rzz(2 gamma)) per edge and the mixer is
    ``rx(2 beta)`` per qubit, every gate in layer l sharing that layer's
    scalar."""
    h = np.array([[1, 1], [1, -1]], dtype=np.complex128) / math.sqrt(2)
    ops: list = [Prim(h, (q,)) for q in range(n)]
    for layer in range(p_layers):
        for i, j in edges:
            a, b = (i, j) if i < j else (j, i)
            ops.append(PGate("rzz", (a, b), (layer,), scale=2.0))
        for q in range(n):
            ops.append(PGate("rx", (q,), (p_layers + layer,), scale=2.0))
    return Ansatz(n, tuple(ops), 2 * p_layers)


def tfim_hva_ansatz(n: int, layers: int, periodic: bool = False) -> Ansatz:
    """Hamiltonian-variational ansatz for the transverse-field Ising model
    (H = -J sum ZZ - h sum X): start from |+>^n, then alternate
    e^{-i theta_l sum ZZ} (rzz bond layers, one shared parameter) and
    e^{-i phi_l sum X} (rx site layers). 2*layers params:
    ``[theta_0, phi_0, theta_1, phi_1, ...]``."""
    h = np.array([[1, 1], [1, -1]], dtype=np.complex128) / math.sqrt(2)
    ops: list = [Prim(h, (q,)) for q in range(n)]
    last = n if periodic and n > 2 else n - 1
    for layer in range(layers):
        for q in range(last):
            ops.append(PGate("rzz", (q, (q + 1) % n) if q + 1 < n
                             else (0, q), (2 * layer,), scale=2.0))
        for q in range(n):
            ops.append(PGate("rx", (q,), (2 * layer + 1,), scale=2.0))
    return Ansatz(n, tuple(ops), 2 * layers)


def maxcut_terms(n: int, edges):
    """(terms, constant) so that constant + sum terms = the MaxCut value
    <sum_edges (1 - Z_i Z_j)/2>."""
    terms = []
    for i, j in edges:
        p = ["I"] * n
        p[i] = p[j] = "Z"
        terms.append((-0.5, "".join(p)))
    return terms, 0.5 * len(edges)


# ---------------------------------------------------------------------------
# Readout and export
# ---------------------------------------------------------------------------


def sample_fn(ansatz: Ansatz):
    """``(theta, shots, gen=None) -> {bitstring: count}``: prepare the
    ansatz state and draw shots with the two-level sampler
    (:func:`ops.sample.sample_counts`); ``gen`` is a CPU
    ``torch.Generator`` (None: torch's global generator)."""
    from ..ops.sample import sample_counts

    run = state_fn(ansatz)

    def sample(theta, shots: int, gen=None):
        with torch.no_grad():
            state = run(theta)
        return sample_counts(state, ansatz.n, shots, gen)

    return sample


def bind(ansatz: Ansatz, theta) -> list[Prim]:
    """Evaluate every parameterized gate at ``theta`` (float64 builders)
    into a host-constant :class:`Prim` stream: the bridge to the compiled
    engine, the mesh executor and, via :func:`models.circuits.prims_qasm`,
    the QASM surfaces."""
    if isinstance(theta, torch.Tensor):
        theta = theta.detach().cpu().numpy()
    theta = np.asarray(theta, dtype=np.float64)
    prims: list[Prim] = []
    for op in ansatz.ops:
        if not isinstance(op, PGate):
            prims.append(op)
            continue
        kind, u = _op_matrix(op, theta)
        prims.append(Prim(u, op.targets, diag=(kind == "diag")))
    return prims


def ansatz_qasm(ansatz: Ansatz, theta, measure: bool = False) -> str:
    """OpenQASM 2.0 text of the ansatz bound at ``theta`` (state equal up
    to a global phase)."""
    from .circuits import prims_qasm

    return prims_qasm(ansatz.n, bind(ansatz, theta), measure=measure)
