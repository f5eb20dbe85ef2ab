"""The port's circuit DSL (Gate, StateVec, Session, algebra) on the CPU.

* ``Gate.matrix()`` of every constructor and combinator against the JAX
  package's, gates built by the same code in both packages;
* the laws of tests/test_gates.py, tests/test_statevec.py and
  tests/test_algebra.py, run against the port;
* the teleportation DSL run (examples/teleportation.py);
* the appliers ``apply_gate`` / ``apply_diag`` reach the kernel wrappers
  (``kernels.gate``, ``kernels.lane``, ``kernels.diag``) and agree with the
  JAX package's appliers.

Tolerances: matrices and amplitudes 1e-6 absolute (complex64 round-off of
entries of modulus <= 1); algebra laws as in tests/test_algebra.py.
Random outcomes are checked with ``chi2_test`` or by determinism under one
generator seed, never draw for draw against JAX."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import qubism_torch as tq  # noqa: E402
import qubism_tpu as jq  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core import algebra as alg  # noqa: E402
from qubism_torch.core.gates import u3_matrix  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
from qubism_torch.ops import fusion as TF  # noqa: E402
from qubism_torch.ops import kernels as TK  # noqa: E402
from qubism_torch.utils.stats import chi2_test  # noqa: E402
from qubism_tpu.ops import apply as JA  # noqa: E402

ATOL = 1e-6
I2 = np.eye(2)
X = np.array([[0, 1], [1, 0]], dtype=complex)
Z = np.diag([1, -1]).astype(complex)
H = np.array([[1, 1], [1, -1]], dtype=complex) / math.sqrt(2)
CX = np.eye(4, dtype=complex)[[0, 1, 3, 2]]


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def kron(*ms):
    out = np.array([[1.0 + 0j]])
    for m in ms:
        out = np.kron(out, m)
    return out


def rand_amps(rng, n):
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


def rand_state(rng, n):
    return tq.StateVec.from_amplitudes(rand_amps(rng, n))


def to_port(g):
    """A JAX-package Gate as the port's (both keep host numpy matrices)."""
    return tq.Gate(g.n, [tq.Prim(p.u, tuple(p.targets), p.diag) for p in g.prims])


# -- every constructor and combinator against the JAX package ----------------

BUILDERS = {
    "ident": lambda m: m.ident(2),
    "pauli_x": lambda m: m.pauli_x(),
    "pauli_y": lambda m: m.pauli_y(),
    "pauli_z": lambda m: m.pauli_z(),
    "hadamard": lambda m: m.hadamard(),
    "phase": lambda m: m.phase(0.7),
    "unitary": lambda m: m.unitary(0.3, 1.1, -0.4),
    "unitary_diagonal": lambda m: m.unitary(0.0, 0.0, 0.9),
    "cnot": lambda m: m.cnot(0, 1, 2),
    "cnot_reversed": lambda m: m.cnot(2, 0, 3),
    "swap": lambda m: m.swap(0, 2, 3),
    "controlled_dense": lambda m: m.controlled(0, m.on_just(2, m.hadamard(), 3)),
    "controlled_diag": lambda m: m.controlled(1, m.on_just(0, m.phase(0.3), 3)),
    "controlled_cnot": lambda m: m.controlled(0, m.cnot(1, 2, 3)),
    "if_bit_1": lambda m: m.if_bit(1, m.on_just(1, m.pauli_y(), 2)),
    "if_bit_0": lambda m: m.if_bit(0, m.on_just(1, m.pauli_y(), 2)),
    "kronecker": lambda m: m.kronecker(m.cnot(0, 1, 2), m.unitary(1.0, 0.5, 0.25)),
    "on_just": lambda m: m.on_just(1, m.hadamard(), 3),
    "on_every": lambda m: m.on_every(m.unitary(0.4, 0.1, 0.2), 3),
    "on_range": lambda m: m.on_range(1, 2, m.pauli_x(), 4),
    "matmul": lambda m: m.cnot(0, 1, 2) @ m.on_just(0, m.hadamard(), 2),
    "then": lambda m: m.on_just(0, m.hadamard(), 2).then(m.controlled(0, m.on_just(1, m.phase(1.2), 2))),
    "qft3": lambda m: (m.on_just(0, m.hadamard(), 3)
                       .then(m.controlled(1, m.on_just(0, m.phase(math.pi / 2), 3)))
                       .then(m.controlled(2, m.on_just(0, m.phase(math.pi / 4), 3)))
                       .then(m.on_just(1, m.hadamard(), 3))
                       .then(m.controlled(2, m.on_just(1, m.phase(math.pi / 2), 3)))
                       .then(m.on_just(2, m.hadamard(), 3))),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_gate_matrix_equals_jax(name):
    mine, theirs = BUILDERS[name](tq), BUILDERS[name](jq)
    assert mine.n == theirs.n and len(mine.prims) == len(theirs.prims)
    for p, q in zip(mine.prims, theirs.prims):
        assert p.targets == q.targets and p.diag == q.diag
        np.testing.assert_allclose(p.u, q.u, atol=1e-15)
    np.testing.assert_allclose(mine.matrix(), theirs.matrix(), atol=ATOL)
    np.testing.assert_allclose(to_port(theirs).matrix(), mine.matrix(), atol=ATOL)


# -- tests/test_gates.py's laws ---------------------------------------------


def test_pauli_and_hadamard_matrices():
    assert np.allclose(tq.pauli_x().matrix(), X, atol=ATOL)
    assert np.allclose(tq.pauli_z().matrix(), Z, atol=ATOL)
    assert np.allclose(tq.hadamard().matrix(), H, atol=ATOL)
    assert np.allclose(tq.pauli_y().matrix(), [[0, -1j], [1j, 0]], atol=ATOL)


@pytest.mark.parametrize("seed", range(4))
def test_u3_is_unitary(seed):
    th, ph, lm = np.random.default_rng(seed).uniform(0, 4 * np.pi, size=3)
    u = u3_matrix(th, ph, lm)
    assert np.allclose(u @ u.conj().T, I2, atol=1e-12)


def test_u3_special_values_and_reference_bug():
    lam = 0.7
    assert np.allclose(u3_matrix(0, 0, lam), np.diag([1, np.exp(1j * lam)]), atol=1e-12)
    assert np.allclose(u3_matrix(np.pi, 0, np.pi), X, atol=1e-12)
    assert np.allclose(u3_matrix(np.pi / 2, 0, np.pi), H, atol=1e-12)
    assert np.allclose(u3_matrix(0, 0, lam, reference_bug=True), np.exp(1j * lam / 2) * I2,
                       atol=1e-12)
    u2 = u3_matrix(np.pi / 3, 0.2, 0.7, reference_bug=True)
    assert not np.allclose(u2 @ u2.conj().T, I2, atol=1e-6)


def test_combinators_against_kron():
    assert np.allclose(tq.on_just(1, tq.hadamard(), 3).matrix(), kron(I2, H, I2), atol=ATOL)
    assert np.allclose(tq.on_every(tq.hadamard(), 2).matrix(), kron(H, H), atol=ATOL)
    assert np.allclose(tq.on_range(1, 2, tq.pauli_x(), 3).matrix(), kron(I2, X, X), atol=ATOL)
    assert np.allclose(tq.kronecker(tq.pauli_x(), tq.hadamard()).matrix(), kron(X, H), atol=ATOL)
    assert np.allclose(tq.cnot(0, 1, 2).matrix(), CX, atol=ATOL)
    ch = np.eye(4, dtype=complex)
    ch[2:, 2:] = H
    assert np.allclose(tq.controlled(0, tq.on_just(1, tq.hadamard(), 2)).matrix(), ch, atol=ATOL)
    assert np.allclose(tq.controlled(0, tq.on_just(1, tq.pauli_z(), 2)).matrix(),
                       np.diag([1, 1, 1, -1]), atol=ATOL)


def test_composition_order_and_equality():
    assert np.allclose((tq.pauli_x() @ tq.hadamard()).matrix(), X @ H, atol=ATOL)
    assert np.allclose(tq.hadamard().then(tq.pauli_x()).matrix(), X @ H, atol=ATOL)
    assert tq.hadamard() @ tq.hadamard() == tq.ident(1)
    assert tq.pauli_x() != tq.pauli_z()
    with pytest.raises(ValueError, match="sizes differ"):
        tq.cnot(0, 1, 2) @ tq.hadamard()
    with pytest.raises(ValueError, match="overlaps"):
        tq.controlled(0, tq.on_just(0, tq.hadamard(), 2))


def test_apply_gate_arbitrary_target_order(rng):
    n = 3
    v = rand_amps(rng, n).astype(np.complex64)
    got = TA.complex_from_state(TA.apply_gate(torch.from_numpy(v.copy()), CX, (2, 0), n))
    full = np.zeros((8, 8), dtype=complex)
    for idx in range(8):
        b = [(idx >> (n - 1 - q)) & 1 for q in range(n)]
        full[((b[0] ^ b[2]) << 2) | (b[1] << 1) | b[2], idx] = 1
    assert np.allclose(got, full @ v, atol=ATOL)


def test_gate_call_leaves_its_argument(rng):
    sv = rand_state(rng, 3)
    before = sv.amps.copy()
    out = tq.on_just(1, tq.hadamard(), 3)(sv)
    assert out is not sv and np.allclose(sv.amps, before, atol=0)
    with pytest.raises(ValueError, match="applied to"):
        tq.hadamard()(sv)


def test_matrix_guard_refuses_large_n():
    with pytest.raises(ValueError, match="refusing past"):
        tq.on_just(0, tq.hadamard(), 13).matrix()


def teleport(alice, seed):
    """examples/teleportation.py in the port's DSL."""
    pair = (tq.cnot(0, 1, 2) @ tq.on_just(0, tq.hadamard(), 2))(tq.mk_state_vec(2))
    s = tq.Session(alice.tensor(pair), seed=seed)
    s.gate(tq.cnot(0, 1, 3))
    s.gate(tq.on_just(0, tq.hadamard(), 3))
    c0 = s.measure_qubit(0)
    c1 = s.measure_qubit(1)
    s.gate(tq.if_bit(c0, tq.on_just(2, tq.pauli_z(), 3)))
    s.gate(tq.if_bit(c1, tq.on_just(2, tq.pauli_x(), 3)))
    return s, c0, c1


def test_teleportation_dsl():
    rng = np.random.default_rng(42)
    seen = set()
    for seed in range(8):
        a, b = rng.normal(size=2) + 1j * rng.normal(size=2)
        target = np.array([a, b]) / math.sqrt(abs(a) ** 2 + abs(b) ** 2)
        s, c0, c1 = teleport(tq.StateVec.from_amplitudes(target), seed)
        seen.add((c0, c1))
        tele = s.state().amps.reshape(2, 2, 2)[c0, c1, :]
        tele = tele / np.linalg.norm(tele)
        phase = tele[np.argmax(np.abs(tele))] / target[np.argmax(np.abs(tele))]
        assert np.allclose(tele, target * phase, atol=1e-5)
    assert len(seen) > 1  # the measurements are random
    s, _, _ = teleport(tq.StateVec.qubit(0.6, 0.8j), seed=42)
    assert s.state().prob_one(2) == pytest.approx(0.64, abs=1e-5)


def test_session_owns_a_copy_and_is_deterministic():
    bell = (tq.cnot(0, 1, 2) @ tq.on_just(0, tq.hadamard(), 2))(tq.mk_state_vec(2))
    outs = set()
    for _ in range(3):
        s = tq.Session(bell, seed=123)
        outs.add((s.measure_qubit(0), s.measure_qubit(1)))
    assert len(outs) == 1
    b0, b1 = outs.pop()
    assert b0 == b1  # Bell correlations
    assert bell.probability("00") == pytest.approx(0.5, abs=1e-6)  # untouched
    cr = tq.Session(bell, seed=5).measure()
    assert str(cr) in ("00", "11")


# -- tests/test_statevec.py's laws ------------------------------------------


def test_init_to_zero_ket():
    amps = tq.mk_state_vec(3).amps
    assert amps[0] == 1 and np.all(amps[1:] == 0)
    assert tq.mk_state_vec(3).dimension == 3 and tq.mk_qubit().n == 1


def test_tensor_outer_product(rng):
    a, b = rand_state(rng, 2), rand_state(rng, 1)
    t = a.tensor(b)
    assert t.n == 3 and np.allclose(t.amps, np.kron(a.amps, b.amps), atol=ATOL)


def test_approx_equality(rng):
    a = rand_state(rng, 3)
    assert a == tq.StateVec.from_amplitudes(a.amps + 1e-8)
    assert a != tq.StateVec.from_amplitudes(a.amps + 1e-2)
    assert a != rand_state(rng, 2)


def test_collapse_big_endian():
    bell = np.array([1, 0, 0, 1]) / math.sqrt(2)
    c = tq.StateVec.from_amplitudes(bell).collapse(0, 1)
    assert np.allclose(c.amps, [0, 0, 0, 1], atol=ATOL)
    c0 = tq.StateVec.from_amplitudes(bell).collapse(1, 0)
    assert np.allclose(c0.amps, [1, 0, 0, 0], atol=ATOL)


def test_measurement_idempotence(rng):
    """measure >> measure == measure (StateVecSpec.hs:35-44)."""
    for trial in range(5):
        sv = rand_state(rng, 3)
        gen = torch.Generator().manual_seed(trial)
        cr1 = sv.measure(gen)
        after = sv.amps.copy()
        assert np.max(np.abs(after) ** 2) > 1 - 1e-5  # a basis state
        assert sv.measure(gen).bits == cr1.bits
        assert np.allclose(sv.amps, after, atol=ATOL)


def test_measure_qubit_idempotent(rng):
    sv = rand_state(rng, 2)
    gen = torch.Generator().manual_seed(7)
    b1 = sv.measure_qubit(0, gen)
    after = sv.amps.copy()
    assert sv.measure_qubit(0, gen) == b1
    assert np.allclose(sv.amps, after, atol=ATOL)


@pytest.mark.parametrize("sqrt_born", [False, True])
def test_born_statistics(sqrt_born):
    """p(1) for amplitude sqrt(0.2) follows the Born rule (or, with the
    compat flag, the reference's r < sqrt(p) quirk): chi2 at alpha 1e-3."""
    p = 0.2
    sv = tq.StateVec.from_amplitudes(np.array([math.sqrt(1 - p), math.sqrt(p)]))
    gen = torch.Generator().manual_seed(11)
    config.reference_sqrt_born = sqrt_born
    try:
        ones = sum(tq.StateVec(1, sv.state.clone()).measure_qubit(0, gen) for _ in range(2000))
    finally:
        config.reference_sqrt_born = False
    p1 = math.sqrt(p) if sqrt_born else p
    res = chi2_test([2000 - ones, ones], [1 - p1, p1])
    assert bool(res), res


def test_show_norm_shape_and_adjoint():
    assert str(tq.mk_state_vec(1)) == " 1.0000  +  0.0000i  |0>\n 0.0000  +  0.0000i  |1>\n"
    sv = tq.StateVec.from_amplitudes(np.array([3, 0, 4, 0]))
    assert abs(sv.norm() - 5) < 1e-5
    assert abs(sv.normalize().norm() - 1) < ATOL
    with pytest.raises(ValueError):
        tq.StateVec(2, torch.zeros(3, dtype=torch.complex64))
    with pytest.raises(ValueError):
        tq.StateVec.from_amplitudes(np.zeros(3))
    q = tq.StateVec.from_amplitudes(np.array([0.6, 0.8j]))
    assert np.allclose(q.adjoint().amps, np.conj(q.amps), atol=1e-7)
    assert np.isclose(q.adjoint().inner(q.adjoint()), 1.0)
    assert q.inner(tq.StateVec.qubit(1, 0)) == pytest.approx(0.6, abs=ATOL)


def test_amplitude_queries(rng):
    sv = rand_state(rng, 3)
    amps = sv.amps
    for idx in range(8):
        s = format(idx, "03b")
        assert sv.amplitude(idx) == pytest.approx(amps[idx], abs=ATOL)
        assert sv.amplitude(s) == pytest.approx(amps[idx], abs=1e-12)
        assert sv.amplitude([int(c) for c in s]) == pytest.approx(amps[idx], abs=1e-12)
    for bad in ("012", "0", 8, [0, 1, 1, 0]):
        with pytest.raises(ValueError):
            sv.amplitude(bad)
    probs = rand_state(rng, 4).probs()
    assert probs.sum() == pytest.approx(1.0, abs=1e-5)
    sv4 = tq.StateVec.from_amplitudes(np.sqrt(probs))
    for idx in (0, 7, 15):
        assert sv4.probability(idx) == pytest.approx(probs[idx], abs=ATOL)
    big = tq.StateVec.zero(2)
    big.n = 27  # the guard fires before any transfer
    with pytest.raises(ValueError, match="probs"):
        big.probs()


def test_sample_is_nondestructive_and_reproducible():
    bell = tq.StateVec.from_amplitudes(np.array([1, 0, 0, 1]) / math.sqrt(2))
    counts = bell.sample(4096, seed=3)
    assert set(counts) <= {"00", "11"} and sum(counts.values()) == 4096
    res = chi2_test([counts.get("00", 0), counts.get("11", 0)], [0.5, 0.5])
    assert bool(res), res
    assert bell.probability("00") == pytest.approx(0.5, abs=ATOL)
    assert bell.sample(256, seed=9) == bell.sample(256, seed=9)


# -- tests/test_algebra.py's laws -------------------------------------------

LAW_TOL = 1e-5


def rand_vec(rng, dim):
    return (rng.normal(size=dim) + 1j * rng.normal(size=dim)).astype(np.complex64)


def rand_mat(rng, dim):
    return (rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))).astype(np.complex64)


def close(a, b, tol=LAW_TOL):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))) < tol


@pytest.mark.parametrize("dim", [2, 8])
def test_vector_space_and_hilbert_laws(rng, dim):
    for _ in range(20):
        a, b, c = (rand_vec(rng, dim) for _ in range(3))
        z, w = complex(rng.normal(), rng.normal()), complex(rng.normal(), rng.normal())
        assert close(alg.add(alg.add(a, b), c), alg.add(a, alg.add(b, c)))
        assert close(alg.add(a, b), alg.add(b, a))
        assert close(alg.add(a, alg.zero_like(a)), a)
        assert close(alg.add(a, alg.neg(a)), alg.zero_like(a))
        assert close(alg.scale(z, alg.add(a, b)), alg.add(alg.scale(z, a), alg.scale(z, b)))
        assert close(alg.scale(z + w, a), alg.add(alg.scale(z, a), alg.scale(w, a)))
        assert close(alg.scale(z * w, a), alg.scale(z, alg.scale(w, a)))
        lhs = alg.inner(a, alg.add(alg.scale(z, b), c))
        assert abs(complex(lhs) - (z * alg.inner(a, b) + alg.inner(a, c))) < LAW_TOL * 10
        assert abs(complex(alg.inner(a, b)) - complex(alg.inner(b, a)).conjugate()) < LAW_TOL
        assert abs(float(alg.norm(a)) ** 2 - complex(alg.inner(a, a)).real) < LAW_TOL * 10


@pytest.mark.parametrize("dim", [2, 4])
def test_algebra_bilinearity_and_commutators(rng, dim):
    for _ in range(20):
        a, b, c = (rand_mat(rng, dim) for _ in range(3))
        z = complex(rng.normal(), rng.normal())
        assert close(alg.mul(alg.add(a, b), c), alg.add(alg.mul(a, c), alg.mul(b, c)), 1e-3)
        assert close(alg.mul(a, alg.add(b, c)), alg.add(alg.mul(a, b), alg.mul(a, c)), 1e-3)
        assert close(alg.mul(alg.scale(z, a), b), alg.scale(z, alg.mul(a, b)), 1e-3)
        assert close(alg.commutator(a, b), alg.neg(alg.commutator(b, a)), 1e-3)
        assert close(alg.add(alg.commutator(a, b), alg.anticommutator(a, b)),
                     alg.scale(2.0, alg.mul(a, b)), 1e-3)


def test_pauli_commutators():
    x, y, z = tq.pauli_x().matrix(), tq.pauli_y().matrix(), tq.pauli_z().matrix()
    assert close(alg.commutator(x, y), alg.scale(2j, z))
    assert close(alg.anticommutator(x, y), alg.zero_like(x))


# -- the appliers dispatch to the kernel wrappers ----------------------------


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Count calls of kernels.gate / lane / diag (each still runs)."""
    calls = []
    for name in ("gate", "lane", "diag"):
        def counted(*args, _real=getattr(TK, name), _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(TK, name, counted)
    return calls


def jax_apply(fn, v, op, targets, n):
    planes = jnp.asarray(JA.planar_from_complex(v))
    return JA.complex_from_planar(fn(planes, op, targets, n))


@pytest.mark.parametrize("targets,expect", [
    ((8,), "lane"), ((9, 4), "lane"),              # all in the lane block (qubits 3..9)
    ((0,), "gate"), ((5, 0), "gate"), ((9, 1, 6), "gate"), ((0, 1, 2, 5), "gate"),
    ((4, 0, 1, 2, 3), None),                       # 5 targets off the lane block: plain
])
def test_apply_gate_dispatch(wrapper_calls, targets, expect):
    n = 10
    rng = np.random.default_rng(len(targets) * 17 + targets[0])
    k = len(targets)
    u = np.linalg.qr(rng.normal(size=(1 << k, 1 << k)) + 1j * rng.normal(size=(1 << k, 1 << k)))[0]
    v = rand_amps(rng, n).astype(np.complex64)
    got = TA.complex_from_state(TA.apply_gate(torch.from_numpy(v.copy()), u, targets, n))
    assert wrapper_calls == ([expect] if expect else [])
    assert np.allclose(got, jax_apply(JA.apply_gate, v, u, targets, n), atol=ATOL)


@pytest.mark.parametrize("targets", [(2, 7), (9,), (6, 0, 8, 3, 1)])
def test_apply_diag_dispatch(wrapper_calls, targets):
    n = 10
    rng = np.random.default_rng(sum(targets))
    d = np.exp(1j * rng.uniform(0, 2 * math.pi, 1 << len(targets)))
    v = rand_amps(rng, n).astype(np.complex64)
    got = TA.complex_from_state(TA.apply_diag(torch.from_numpy(v.copy()), d, targets, n))
    assert wrapper_calls == ["diag"]
    assert np.allclose(got, jax_apply(JA.apply_diag, v, d, targets, n), atol=ATOL)


def test_gate_call_reaches_the_kernel_wrappers(wrapper_calls):
    """A 10-qubit QFT from hadamard / controlled(phase) goes through the
    appliers: dense 1q gates to gate or lane, the phases to diag."""
    n = 10
    qft = tq.ident(n)
    for q in range(n):
        qft = qft.then(tq.on_just(q, tq.hadamard(), n))
        for j in range(q + 1, n):
            qft = qft.then(tq.controlled(j, tq.on_just(q, tq.phase(math.pi / (1 << (j - q))), n)))
    out = qft(tq.mk_state_vec(n))
    assert wrapper_calls.count("diag") == n * (n - 1) // 2
    assert wrapper_calls.count("gate") == n - 7 and wrapper_calls.count("lane") == 7
    assert np.allclose(np.abs(out.amps) ** 2, 1 / (1 << n), atol=ATOL)
    compiled = TF.CompiledCircuit(n, qft.prims)
    assert compiled.stats()["fused_stage_blocks"] > 0
    state = compiled(compiled.init_state())
    assert np.allclose(compiled.state_to_complex(state), out.amps, atol=ATOL)
