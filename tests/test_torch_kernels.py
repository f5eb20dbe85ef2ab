"""The port's four kernels (their plain versions, which the wrappers run on
a CPU tensor) against the JAX package's Pallas kernels in interpret mode, on
the same random states. Tolerance: relative L2 <= 1e-5 at complex64, the
bound of tests/test_kernels.py."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import qubism_tpu.ops.kernels as JK  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
from qubism_torch.ops import kernels as TK  # noqa: E402
from qubism_torch.ops.measure import probabilities  # noqa: E402
from qubism_tpu.core.gates import u3_matrix  # noqa: E402

TOL = 1e-5
CX = np.eye(4, dtype=complex)[[0, 1, 3, 2]]
CCX = np.eye(8, dtype=complex)[[0, 1, 2, 3, 4, 5, 7, 6]]


@pytest.fixture(autouse=True)
def modes():
    JK.INTERPRET = True
    old = config.device
    config.device = "cpu"
    yield
    JK.INTERPRET = False
    config.device = old


def rand_planes(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    v /= np.linalg.norm(v)
    return v.real.astype(np.float32), v.imag.astype(np.float32)


def unitary(k, rng):
    m = rng.normal(size=(1 << k, 1 << k)) + 1j * rng.normal(size=(1 << k, 1 << k))
    return np.linalg.qr(m)[0]


def jax_planes(re, im):
    return (jnp.asarray(re), jnp.asarray(im))


def to_complex(re, im):
    re = np.asarray(re, dtype=np.float64).reshape(-1)
    im = np.asarray(im, dtype=np.float64).reshape(-1)
    return re + 1j * im


def rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def run_port(name, re, im, *args):
    state = TA.state_from_planes(re, im)
    out = getattr(TK, name)(state, *args)
    assert out is state  # in place
    return to_complex(*TA.planes_from_state(state))


@pytest.mark.parametrize("n,targets,kind", [
    (8, (0,), "u"), (9, (8,), "u"), (10, (3, 7), "u"), (12, (0, 5, 11), "u"),
    (13, (1, 2, 11, 12), "u"), (15, (4,), "u"), (11, (2, 9), "cx"),
    (14, (0, 6, 13), "ccx"),
])
def test_gate_matches_pallas_row_gate(n, targets, kind):
    rng = np.random.default_rng(n * 7 + len(targets))
    u = {"u": lambda: unitary(len(targets), rng), "cx": lambda: CX,
         "ccx": lambda: CCX}[kind]()
    re, im = rand_planes(n, n + 1)
    want = to_complex(*JK.row_gate(jax_planes(re, im), u, targets, n))
    got = run_port("gate", re, im, u, targets, n)
    assert rel(got, want) <= TOL


def _diag(rng, k):
    return np.exp(1j * rng.uniform(0, 2 * math.pi, 1 << k))


@pytest.mark.parametrize("n,case", [
    (8, "ladder"), (11, "ladder"), (12, "straddle"), (13, "onepoint"), (15, "straddle"),
])
def test_diag_matches_pallas_diag_layer(n, case):
    rng = np.random.default_rng(n)
    if case == "ladder":
        cu1 = lambda lam: np.array([1, 1, 1, np.exp(1j * lam)])  # noqa: E731
        factors = [(np.array([1, 1, 1, -1], dtype=complex), (0, n - 1)),
                   (cu1(0.3), (1, 2)), (np.array([1, 1j]), (n - 2,)),
                   (cu1(0.7), (0, n - 2))]
    elif case == "straddle":
        # factors across the low 7 qubits, including a full 7-qubit lane table
        factors = [(_diag(rng, 3), (1, n - 8, n - 3)),
                   (_diag(rng, 4), (n - 9, n - 8, n - 7, n - 6)),
                   (_diag(rng, 7), tuple(range(n - 7, n))),
                   (_diag(rng, 2), (n - 1, 0))]
    else:
        # one point of 8 qubits: wider than a table, so the port splits it
        d = np.ones(256, dtype=complex)
        d[int(rng.integers(256))] = np.exp(0.9j)
        factors = [(d, (0, 2, 4, 6, 8, 10, 11, 12))]
        assert len(factors[0][1]) > TK._TABLE_BITS_MAX
    re, im = rand_planes(n, n + 2)
    want = to_complex(*JK.diag_layer(jax_planes(re, im), factors, n))
    got = run_port("diag", re, im, factors, n)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("n,targets", [
    (8, (6, 7)), (10, (3, 9)), (12, tuple(range(5, 12))), (15, (14,)), (5, (0, 3)),
])
def test_lane_matches_pallas_lane_gate(n, targets):
    from qubism_tpu.ops.apply import expand_for_view as jax_expand

    rng = np.random.default_rng(n + 100)
    u = unitary(len(targets), rng)
    ue = TA.expand_for_view(u, n, targets)
    np.testing.assert_allclose(ue, jax_expand(u, n, targets))
    re, im = rand_planes(n, n + 3)
    want = to_complex(*JK.lane_gate(jax_planes(re, im), ue, n))
    got = run_port("lane", re, im, ue, n)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("n,qubits", [
    (10, (0, 1, 2, 3)), (12, (0, 2, 3, 4, 6)), (15, (0, 3, 5, 7, 9, 11)), (9, (8, 1)),
])
def test_layer1q_matches_pallas_layer1q(n, qubits):
    rng = np.random.default_rng(n + len(qubits))
    gates = tuple((u3_matrix(*rng.uniform(0, 2 * math.pi, 3), reference_bug=False), q)
                  for q in qubits)
    re, im = rand_planes(n, n + 4)
    fn, coefs = JK.layer1q_prepare(gates, n)
    want = to_complex(*fn(jax_planes(re, im), coefs))
    got = run_port("layer1q", re, im, gates, n)
    assert rel(got, want) <= TOL


def test_wrappers_validate_operands():
    state = TA.zero_state(4)
    with pytest.raises(ValueError):
        TK.gate(state, np.eye(32), (0, 1, 2, 3, 3), 4)
    with pytest.raises(ValueError):
        TK.layer1q(state, ((np.eye(2), 1), (np.eye(2), 1)), 4)
    with pytest.raises(ValueError):
        TK.lane(state, np.eye(8), 4)
    with pytest.raises(ValueError):
        TK.gate(state.clone()[:8], np.eye(2), (0,), 4)


def test_zero_diag_factor_cannot_be_split():
    d = np.ones(256, dtype=complex)
    d[3] = 0
    with pytest.raises(ValueError, match="zero entry"):
        TK._diag_passes([(d, tuple(range(8)))], 8)


def test_cpu_tensors_never_count_a_launch():
    TK.reset_launches()
    state = TA.zero_state(9)
    TK.gate(state, CX, (0, 4), 9)
    TK.lane(state, TA.expand_for_view(CX, 9, (3, 8)), 9)
    TK.diag(state, [(np.array([1, -1]), (2,))], 9)
    TK.layer1q(state, ((np.eye(2), 1), (np.eye(2), 0)), 9)
    ladder = ((np.array([1, 1, 1, 1j]), (0, 5)),)
    TK.stage_block(state, TK.stage_block_prepare(((np.eye(2), 0, ladder),), 9, "cpu"), 9)
    TK.shard_butterfly(list(state.view(2, -1)), np.eye(2)[::-1], 8)
    TK.permute(state, (8, 1, 2, 3, 4, 5, 6, 7, 0), 9)
    TK.pair_sums(state, state, 3, [0, 5], torch.zeros(2, 2, dtype=torch.float64), 9)
    assert TK.launches == {"gate": 0, "diag": 0, "lane": 0, "layer1q": 0, "stage": 0,
                           "butterfly": 0, "permute": 0, "pair": 0}


@pytest.mark.parametrize("targets", [(3, 1), (5, 0, 2), (6,)])
def test_plain_appliers_match_jax_apply(targets):
    """apply_gate / apply_diag take targets in any order (targets[0] = MSB)."""
    from qubism_tpu.ops import apply as JA
    from qubism_tpu.ops import measure as JM

    n = 7
    rng = np.random.default_rng(len(targets))
    u = unitary(len(targets), rng)
    d = _diag(rng, len(targets))
    re, im = rand_planes(n, 11)
    want = JA.apply_diag(JA.apply_gate(jax_planes(re, im), u, targets, n), d, targets, n)
    state = TA.state_from_planes(re, im)
    assert TA.apply_diag(TA.apply_gate(state, u, targets, n), d, targets, n) is state
    assert rel(TA.complex_from_state(state), to_complex(*want)) <= TOL
    scaled = TA.state_from_planes(3 * re, 3 * im)
    want = JA.normalize((jnp.asarray(3 * re), jnp.asarray(3 * im)))
    assert rel(TA.complex_from_state(TA.normalize(scaled)), to_complex(*want)) <= TOL
    want = JM.probabilities(jax_planes(*TA.planes_from_state(state)), n)
    np.testing.assert_allclose(probabilities(state).numpy(), np.asarray(want), atol=1e-7)
