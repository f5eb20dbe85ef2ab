"""Primitive gates of the interpreter's queue.

A :class:`Prim` is a k-qubit unitary on explicit targets. The interpreter
builds 1q ``U`` matrices with :func:`u3_matrix` and queues them with ``CX``;
ops/fusion.py lowers runs of prims into kernel passes. The combinator DSL of
qubism_tpu/core/gates.py (``Gate`` and its constructors) is not ported yet.
"""

from __future__ import annotations

import cmath
import math
from dataclasses import dataclass

import numpy as np

from ..config import config


@dataclass(frozen=True)
class Prim:
    """A primitive k-qubit unitary on explicit targets.

    ``u`` is a (2^k, 2^k) complex matrix, or the (2^k,) diagonal when
    ``diag`` is True. targets[0] is the most significant bit of the local
    index. Matrices are host-side numpy; they are shipped to the device at
    application time.
    """

    u: np.ndarray
    targets: tuple[int, ...]
    diag: bool = False

    def dense(self) -> np.ndarray:
        return np.diag(self.u) if self.diag else self.u


def u3_matrix(theta: float, phi: float, lam: float, reference_bug: bool | None = None) -> np.ndarray:
    """The OpenQASM 2.0 U(theta, phi, lambda) matrix (arXiv:1707.03429 eq. 2).

    The reference's version (QGate.hs:112-118) is non-unitary for generic
    parameters (precedence/sign bug — see SURVEY.md §2.4.1); pass
    ``reference_bug=True`` (or set ``config.reference_u3_bug``) to replicate.
    """
    if reference_bug is None:
        reference_bug = config.reference_u3_bug
    ct, st = math.cos(theta / 2), math.sin(theta / 2)
    if reference_bug:
        a = cmath.exp(1j * (phi + lam / 2)) * ct
        b = -cmath.exp(1j * (phi - lam / 2)) * st
        c = cmath.exp(1j * (phi - lam / 2)) * st
        d = cmath.exp(1j * (phi + lam / 2)) * ct
    else:
        a = ct
        b = -cmath.exp(1j * lam) * st
        c = cmath.exp(1j * phi) * st
        d = cmath.exp(1j * (phi + lam)) * ct
    return np.array([[a, b], [c, d]], dtype=np.complex128)


def is_diagonal(u: np.ndarray) -> bool:
    return bool(np.allclose(u, np.diag(np.diag(u)), atol=1e-12))
