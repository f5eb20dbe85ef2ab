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

The ``mesh=`` argument (the amplitude-sharded variational path of the JAX
package, with its ``models/adjoint_mesh.py``) is not ported yet: it raises
``NotImplementedError``.
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


def _no_mesh(mesh, what: str):
    if mesh is not None:
        raise NotImplementedError(
            f"{what}(mesh=...): the mesh-sharded variational path "
            f"(models/adjoint_mesh.py) is not ported yet")


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


def _apply_op(state, op, theta, n: int, dag: bool = False) -> torch.Tensor:
    """One op (or its dagger) applied to ``state``, out of place."""
    kind, u = _op_matrix(op, theta, dag)
    return _apply_kind(state, kind, u, op.targets, n)


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


def _terms_energy(state: torch.Tensor, n: int, terms, paulis) -> torch.Tensor:
    """Differentiable <psi| sum_j c_j P_j |psi> (a real 0-d tensor). Terms
    are grouped by flip mask f: t(x) = conj(psi[x ^ f]) psi[x] is formed
    once per group and summed down to the qubits of the group's sign masks,
    and each term is a signed sum of that small table, times i^{#Y}."""
    e = torch.zeros((), dtype=torch.float32, device=state.device)
    for f, idxs in M.group_terms(paulis).items():
        t = _flip(state, f, n).conj() * state
        zs = [M.pauli_masks(paulis[j])[1] for j in idxs]
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
        vals = torch.from_numpy(signs).to(device=state.device, dtype=t.dtype) @ r.reshape(-1)
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


def state_fn(ansatz: Ansatz, mesh=None):
    """``theta -> state``: the differentiable state preparation, a complex64
    tensor of 2^n amplitudes on ``config.device`` (``theta`` a float32
    tensor, which may require grad, or an array)."""
    _no_mesh(mesh, "state_fn")

    def run(theta):
        theta = _device_theta(theta)
        state = A.zero_state(ansatz.n)
        for op in ansatz.ops:
            state = _apply_op(state, op, theta, ansatz.n)
        return state

    return run


def energy_fn(ansatz: Ansatz, terms, constant: float = 0.0, mesh=None):
    """``theta -> <psi(theta)| sum_j c_j P_j |psi(theta)> + constant`` as a
    differentiable 0-d float32 tensor. ``terms`` = [(coef, pauli), ...]."""
    _no_mesh(mesh, "energy_fn")
    paulis, _ = _check_terms(terms, ansatz.n)
    run = state_fn(ansatz)

    def energy(theta):
        return _terms_energy(run(theta), ansatz.n, terms, paulis) + float(constant)

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


def _adjoint_bwd_step(op, theta: np.ndarray, phi, lam, g: np.ndarray, n: int):
    """One reverse-sweep step: add this op's parameter gradient into ``g``
    (float64, on the host), then un-apply the op from phi and lam. Returns
    (phi', lam').

    One-parameter gates are Pauli exponentials U = e^{i eta} exp(-i s
    theta_j G) (:data:`_GEN`), so ``dU/dtheta |psi_before> = -i s G
    |psi_after>`` and the gradient is ``2 s Im <lam|G phi>``: one
    :func:`ops.measure.apply_pauli_sum` and one inner product. Multi-parameter
    builders (u3) take the dense derivative of the gate
    (:func:`_builder_jvp`)."""
    if isinstance(op, PGate) and op.name in _GEN and len(op.pidx) == 1:
        gphi = M.apply_pauli_sum(phi, _gen_terms(op, n), n)
        g[op.pidx[0]] += 2.0 * op.scale * float(torch.vdot(lam, gphi).imag)
        del gphi
        return _apply_op(phi, op, theta, n, dag=True), _apply_op(lam, op, theta, n, dag=True)
    phi = _apply_op(phi, op, theta, n, dag=True)  # psi before this op
    if isinstance(op, PGate):
        args = [op.scale * theta[j] for j in op.pidx]
        for li, j in enumerate(op.pidx):
            du = _builder_jvp(op.name, args, li)
            dphi = _apply_kind(phi, _KIND[op.name], du, op.targets, n)
            g[j] += op.scale * 2.0 * float(torch.vdot(lam, dphi).real)
    return phi, _apply_op(lam, op, theta, n, dag=True)


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

    ``segment_size`` is the JAX package's compile control (bounded jitted
    segments); eager torch has no such program, so it changes nothing.
    Energy and gradient come back as float32 CPU tensors."""
    del segment_size
    _no_mesh(mesh, "adjoint_value_and_grad_fn")
    n = ansatz.n
    if engine not in ("auto", "plain", "kernels"):
        raise ValueError(f"engine must be auto|plain|kernels, got {engine!r}")
    if engine != "plain":
        from .adjoint_engine import kernel_adjoint_value_and_grad_fn, supports

        if engine == "kernels" or (n >= 14 and supports(ansatz)):
            return kernel_adjoint_value_and_grad_fn(ansatz, terms, constant)
    _, checked = _check_terms(terms, n)

    def vg(theta):
        th = _host_theta(theta)
        with torch.no_grad():
            phi = A.zero_state(n)
            for op in ansatz.ops:
                phi = _apply_op(phi, op, th, n)
            e = M.expectation_pauli_sum(phi, n, checked) + float(constant)
            lam = M.apply_pauli_sum(phi, checked, n)
            g = np.zeros(ansatz.num_params)
            for op in reversed(ansatz.ops):
                phi, lam = _adjoint_bwd_step(op, th, phi, lam, g, n)
        return torch.tensor(e, dtype=torch.float32), torch.from_numpy(g.astype(np.float32))

    vg._engine = "plain"
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
