"""Algebraic operations on states and operators.

Counterpart of reference src/Qubism/Algebra.hs (VectorSpace / HilbertSpace /
Algebra typeclasses), copied from qubism_tpu/core/algebra.py: numpy only,
on host vectors and matrices, so the law-based property tests have an
explicit surface to exercise.
"""

from __future__ import annotations

import numpy as np


# -- VectorSpace (Algebra.hs:17-28) -----------------------------------------

def zero_like(v):
    return np.zeros_like(v)


def scale(z, v):
    """Scalar multiplication ``z .: v``."""
    return np.asarray(z, dtype=v.dtype) * v


def add(a, b):
    """Vector addition ``a +: b``."""
    return a + b


def sub(a, b):
    """Vector subtraction ``a -: b`` (= a +: neg b)."""
    return a - b


def neg(a):
    return -a


# -- HilbertSpace (Algebra.hs:30-36) ----------------------------------------

def inner(a, b):
    """Sesquilinear inner product <a|b>, conjugate-linear in the first
    argument (matching hmatrix's ``<.>`` used by the reference)."""
    return np.vdot(a, b)


def norm(a) -> np.ndarray:
    return np.sqrt(np.real(inner(a, a)))


# -- Algebra (Algebra.hs:38-46) ----------------------------------------------

def mul(a, b):
    """Bilinear product ``a *: b``: matrix multiplication for operators."""
    return a @ b


def commutator(a, b):
    """[a, b] = ab - ba (Algebra.hs:42-43)."""
    return mul(a, b) - mul(b, a)


def anticommutator(a, b):
    """{a, b} = ab + ba (Algebra.hs:45-46)."""
    return mul(a, b) + mul(b, a)
