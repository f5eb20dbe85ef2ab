"""The plain reference of the variational configurations: a value and its
gradient by the adjoint method, gate by gate, in plain PyTorch.

It takes a gate list that the benchmark's own family emits, never anything
the program made, and imports nothing of the program. A gate is ``(u,
targets, diag, gen)``: its matrix (or its diagonal, where ``diag``) at the
program's angles, on ``targets`` (targets[0] the most significant bit of
the gate's index; qubit q is bit n-1-q of a basis index), and ``gen``, None
for a fixed gate or ``(j, s, pauli)`` where the gate is exp(-i s theta_j P)
with P the Pauli string ``pauli`` on its targets. The observable is a sum of
Z products, ``[(c, qubits)]``.

The sweep (Jones and Gacon, arXiv:2009.02823, Algorithm 1): phi = the
gates applied in order to |0...0>, lam = H phi and E = <phi|lam>; then, for
each gate from the last to the first parameterised one, g_j += 2 s Im <lam|P
phi> (phi is the state just after the gate, so d phi / d theta_j = -i s P
phi), and the gate is un-applied from phi and lam. Gates, and each Pauli
product P phi in a third buffer, are applied by the state-vector
reference's routines (:mod:`.statevec`).

The states are complex128 (three of them, 12 GiB at 28 qubits); each inner
product is one ``torch.vdot`` in complex128. ``tf32=True`` is the control:
complex64 states, every product computed from inputs rounded to TF32's 10
mantissa bits, as ``qbench.reference.simulate(..., tf32=True)`` rounds
them, and the inner products summed in complex128.
"""

from __future__ import annotations

import numpy as np
import torch

from .statevec import _apply_1q, _apply_dense, _apply_diag, _targets_view, round_tf32_

#: the states' type of the sound reference, and of its TF32 control
DTYPE, DTYPE_TF32 = torch.complex128, torch.complex64

_PAULI = {"X": (np.array([[0, 1], [1, 0]], dtype=np.complex128), False),
          "Y": (np.array([[0, -1j], [1j, 0]], dtype=np.complex128), False),
          "Z": (np.array([1, -1], dtype=np.complex128), True)}


def apply(state: torch.Tensor, u, targets, diag: bool, n: int, tf32: bool = False):
    """The gate ``u`` on ``targets`` applied to ``state`` in place, as
    :func:`qbench.reference.simulate` applies it."""
    u = np.asarray(u)
    if diag:
        _apply_diag(state, u, tuple(targets), n, tf32)
    elif len(targets) == 1:
        _apply_1q(state, u, targets[0], n, tf32)
    else:
        _apply_dense(state, u, tuple(targets), n, tf32)


def _vdot(a: torch.Tensor, b: torch.Tensor) -> complex:
    """<a|b>, summed in complex128."""
    return complex(torch.vdot(a.to(torch.complex128), b.to(torch.complex128)))


def forward(n: int, gates, device, tf32: bool = False) -> torch.Tensor:
    """The state of ``gates`` applied to |0...0>."""
    state = torch.zeros(1 << n, dtype=DTYPE_TF32 if tf32 else DTYPE, device=device)
    state[0] = 1
    for u, targets, diag, _ in gates:
        apply(state, u, targets, diag, n, tf32)
    return state


def observable(phi: torch.Tensor, terms, n: int, tf32: bool = False) -> torch.Tensor:
    """lam = H phi for H = sum_k c_k Z_(qubits_k): phi times the weight
    w(x) = sum_k c_k (-1)^(the parity of x on qubits_k), built term by term
    as a real 2^n table."""
    real = torch.float32 if phi.dtype == torch.complex64 else torch.float64
    w = torch.zeros(1 << n, dtype=real, device=phi.device)
    for c, qubits in terms:
        view, index = _targets_view(w, tuple(qubits), n)
        for entry in range(1 << len(qubits)):
            view[index(entry)].add_(-c if bin(entry).count("1") & 1 else c)
    if tf32:
        round_tf32_(phi)
        round_tf32_(w)
    return phi * w


def value_and_grad(n: int, gates, terms, num_params: int, device,
                   tf32: bool = False) -> tuple[float, np.ndarray]:
    """(<H>, d<H>/d theta) of the circuit ``gates`` for H = sum_k c_k
    Z_(qubits_k) (``terms``), by the adjoint sweep; the gradient as a
    float64 host array of ``num_params``."""
    first = next((i for i, g in enumerate(gates) if g[3] is not None), len(gates))
    phi = forward(n, gates, device, tf32)
    lam = observable(phi, terms, n, tf32)
    if tf32:
        round_tf32_(lam)
    value = _vdot(phi, lam).real
    grad = np.zeros(num_params)
    for u, targets, diag, gen in reversed(gates[first:]):
        if gen is not None:
            j, s, pauli = gen
            gphi = phi.clone()
            for q, ch in zip(targets, pauli):
                if ch != "I":
                    p, pdiag = _PAULI[ch]
                    apply(gphi, p, (q,), pdiag, n, tf32)
            if tf32:
                round_tf32_(lam)
                round_tf32_(gphi)
            grad[j] += 2.0 * s * _vdot(lam, gphi).imag
        u = np.asarray(u, dtype=np.complex128)
        back = u.conj() if diag else u.conj().T
        apply(phi, back, targets, diag, n, tf32)
        apply(lam, back, targets, diag, n, tf32)
    return value, grad
