"""Shor order finding and factoring of the port (models/shor.py): the
cases of tests/test_shor.py on the CPU. The circuits equal the JAX
package's prim for prim, the order-finding state its plain-XLA run's to
1e-5; orders and factors are checked by number theory (pow(a, r, N),
multiplication), the port drawing its own shots."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qubism_tpu.models.shor as JS  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.models.shor import (controlled_mod_mult_prim, estimate_order,  # noqa: E402
                                      mod_mult_matrix, phase_to_order, shor_factor,
                                      shor_order_prims)
from qubism_torch.ops import apply as A  # noqa: E402
from qubism_tpu.ops.fusion import CompiledCircuit as JCompiled  # noqa: E402


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def test_mod_mult_matrix_is_permutation_and_correct():
    u = mod_mult_matrix(7, 15, 4)
    assert np.allclose(u @ u.conj().T, np.eye(16))
    for x in range(15):
        assert np.argmax(np.abs(u[:, x])) == (7 * x) % 15
    assert u[15, 15] == 1


def test_mod_mult_matrix_validates():
    with pytest.raises(ValueError, match="factor"):
        mod_mult_matrix(6, 15, 4)
    with pytest.raises(ValueError, match="2\\^"):
        mod_mult_matrix(7, 15, 3)


def test_controlled_prim_blocks():
    u = controlled_mod_mult_prim(2, 5, 0, (1, 2, 3)).u
    assert np.allclose(u[:8, :8], np.eye(8))
    assert np.allclose(u[8:, 8:], mod_mult_matrix(2, 5, 3))


def test_phase_to_order():
    assert 4 in phase_to_order(0.25, 15)
    assert 3 in phase_to_order(1.0 / 3.0, 15)
    assert phase_to_order(0.0, 15) == []
    assert 6 in phase_to_order(85.0 / 512.0, 21)


def test_order_circuit_equals_jax_and_its_state():
    """The prims of the JAX package, and the state of its plain-XLA run:
    the 5-target controlled multiplications go through the plain dense
    applier here, the rest through the kernels' plain versions."""
    prims, n = shor_order_prims(7, 15, t=5)
    jprims, jn = JS.shor_order_prims(7, 15, t=5)
    assert n == jn == 9 and len(prims) == 1 + 5 + 5 + 10 + 5
    for p, q in zip(prims, jprims):
        assert p.targets == q.targets and p.diag == q.diag and np.array_equal(p.u, q.u)
    state = A.zero_state(n)
    for p in prims:
        (A.apply_diag if p.diag else A.apply_gate)(state, p.u, p.targets, n)
    jc = JCompiled(n, jprims, use_pallas=False, virtual_shards=0)
    want = jc.state_to_complex(jc(jc.init_state()))
    assert np.abs(A.complex_from_state(state) - want).max() < 1e-5


@pytest.mark.parametrize("a,n_mod,t,want", [
    (7, 15, 6, 4), (4, 15, 6, 2), (11, 15, 6, 2), (2, 15, 6, 4), (2, 21, 9, 6),
])
def test_estimate_order(a, n_mod, t, want):
    r = estimate_order(a, n_mod, t=t, shots=48, seed=3)
    assert r == want
    assert pow(a, r, n_mod) == 1


def test_shor_factors_15():
    assert sorted(shor_factor(15, seed=1)) == [3, 5]


def test_shor_factors_21():
    assert sorted(shor_factor(21, seed=1, t=9)) == [3, 7]


def test_classical_shortcuts():
    assert shor_factor(8) == (2, 4)
    assert sorted(shor_factor(9)) == [3, 3]
    assert sorted(shor_factor(25)) == [5, 5]
    with pytest.raises(ValueError):
        shor_factor(3)


def test_factors_multiply_back():
    for n_mod in (15, 21):
        p, q = shor_factor(n_mod, seed=2, t=9)
        assert p * q == n_mod and 1 < p < n_mod
        assert math.gcd(p, q) in (1, p)
