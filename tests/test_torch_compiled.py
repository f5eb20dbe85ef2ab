"""The port's compiled engine (``CompiledCircuit``; plain versions on the
CPU) against the JAX package's ``CompiledCircuit(..., use_pallas=False)``
on the circuit families of models/circuits.py and on random prim streams,
after tests/test_fusion.py. Also the fusion's stage blocks and its
wide-diagonal rule. Tolerance: relative L2 <= 1e-5 (complex64)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import qubism_torch.models.circuits as TC  # noqa: E402
import qubism_tpu.models.circuits as JC  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim as TPrim  # noqa: E402
from qubism_torch.ops import apply as TA  # noqa: E402
from qubism_torch.ops import fusion as TF  # noqa: E402
from qubism_tpu.core.gates import Prim as JPrim  # noqa: E402
from qubism_tpu.core.gates import u3_matrix  # noqa: E402
from qubism_tpu.ops import fusion as JF  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def to_port(prims):
    """JAX-package prims -> the port's (both hold host numpy matrices)."""
    return [TPrim(p.u, tuple(p.targets), p.diag) for p in prims]


def random_prims(n, count, seed):
    """u3s, CNOTs and controlled phases on random qubits (tests/test_fusion.py)."""
    rng = np.random.default_rng(seed)
    cnot = np.eye(4, dtype=complex)[[0, 1, 3, 2]]
    prims = []
    for _ in range(count):
        kind = rng.integers(0, 3)
        if kind == 0:
            th, ph, lm = rng.uniform(0, 2 * math.pi, 3)
            prims.append(JPrim(u3_matrix(th, ph, lm, reference_bug=False),
                               (int(rng.integers(0, n)),)))
        elif kind == 1:
            q = rng.permutation(n)[:2]
            prims.append(JPrim(cnot, (int(q[0]), int(q[1]))))
        else:
            q = rng.permutation(n)[:2]
            d = np.array([1, 1, 1, np.exp(1j * rng.uniform(0, 2 * math.pi))])
            prims.append(JPrim(d, (int(q[0]), int(q[1])), diag=True))
    return prims


def rand_vec(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


def run_both(n, jprims, seed=None):
    """The same prims through both engines, from |0> or a random state."""
    if seed is None:
        v = np.zeros(1 << n, dtype=complex)
        v[0] = 1
    else:
        v = rand_vec(n, seed)
    re, im = v.real.astype(np.float32), v.imag.astype(np.float32)
    jc = JF.CompiledCircuit(n, jprims, use_pallas=False)
    want = jc.state_to_complex(jc((jnp.asarray(re), jnp.asarray(im))))
    tc = TF.CompiledCircuit(n, to_port(jprims))
    state = TA.state_from_planes(re, im)
    assert tc(state) is state  # in place
    return tc, TA.complex_from_state(state), want


def rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("family,n", [
    ("qft", 10), ("qft", 12), ("ghz", 12), ("brickwork", 10), ("grover", 9),
    ("qaoa", 10), ("wstate", 9), ("qpe", 8),
])
def test_compiled_matches_jax(family, n):
    jprims = {
        "qft": lambda: JC.qft_prims(n),
        "ghz": lambda: JC.ghz_prims(n),
        "brickwork": lambda: JC.brickwork_prims(n, 4, seed=3),
        "grover": lambda: JC.grover_prims(n, marked=0b101100101, iterations=3),
        "qaoa": lambda: JC.qaoa_prims(n, JC.ring_edges(n), [0.4, 0.9], [0.7, 0.2]),
        "wstate": lambda: JC.w_state_prims(n),
        "qpe": lambda: JC.qpe_prims(n - 1, 0.3125),
    }[family]()
    circ, got, want = run_both(n, jprims, seed=n if family in ("qft", "brickwork") else None)
    assert rel(got, want) <= TOL
    assert circ.stats()["prims"] == len(jprims)


@pytest.mark.parametrize("n,seed", [(6, 0), (6, 1), (8, 2), (10, 3), (11, 4)])
def test_compiled_random_streams_match_jax(n, seed):
    _, got, want = run_both(n, random_prims(n, 40, seed), seed=seed + 100)
    assert rel(got, want) <= TOL


def test_port_circuit_builders_equal_jax():
    """The port's builders emit the JAX package's prims, matrix for matrix."""
    cases = [
        ("qft_prims", (7,)), ("ghz_prims", (6,)), ("brickwork_prims", (5, 3, 9)),
        ("grover_prims", (5, 3, 2)), ("w_state_prims", (5,)),
        ("qaoa_prims", (4, JC.ring_edges(4), [0.1, 0.2], [0.3, 0.4])),
        ("qpe_prims", (4, 0.375)),
    ]
    for name, args in cases:
        a, b = getattr(JC, name)(*args), getattr(TC, name)(*args)
        assert len(a) == len(b), name
        for p, q in zip(a, b):
            assert p.targets == q.targets and p.diag == q.diag, name
            np.testing.assert_allclose(q.u, p.u, atol=1e-15)
    assert TC.ring_edges(2) == JC.ring_edges(2) and TC.ring_edges(5) == JC.ring_edges(5)
    prims = (JC.qaoa_prims(3, JC.ring_edges(3), [0.5], [0.25]) + JC.ghz_prims(3)
             + JC.qpe_prims(2, 0.25))
    assert TC.prims_qasm(3, to_port(prims), measure=True) == JC.prims_qasm(3, prims, measure=True)


def test_optimize_false_matches_optimized():
    n = 9
    prims = to_port(random_prims(n, 30, 99)) + TC.qft_prims(n)
    a = TF.CompiledCircuit(n, prims, optimize=True)
    b = TF.CompiledCircuit(n, prims, optimize=False)
    assert b.num_passes == len(prims) > a.num_passes
    sa, sb = a.init_state(), b.init_state()
    assert rel(a.state_to_complex(a(sa)), b.state_to_complex(b(sb))) <= TOL


@pytest.mark.parametrize("stage_group", [1, 2, 3, 4])
def test_qft16_stage_blocks(stage_group):
    n = 16
    circ = TF.CompiledCircuit(n, TC.qft_prims(n), stage_group=stage_group)
    stats = circ.stats()
    assert stats["max_stage_group"] == stage_group
    assert stats["fused_ops"] <= n // stage_group + 4
    assert stats["fused_stages"] == n - 7  # one stage per row qubit
    assert stats["backend"] == "plain" and stats["virtual_shards"] == 0
    assert set(stats) == set(JF.CompiledCircuit(4, JC.qft_prims(4), use_pallas=False).stats())
    assert [name for name, _ in circ._plans].count("stage") == stats["fused_stage_blocks"]


def test_stage_group_2_and_4_agree_with_jax():
    n = 12
    v = rand_vec(n, 5)
    re, im = v.real.astype(np.float32), v.imag.astype(np.float32)
    jc = JF.CompiledCircuit(n, JC.qft_prims(n), use_pallas=False)
    want = jc.state_to_complex(jc((jnp.asarray(re), jnp.asarray(im))))
    for group in (2, 4):
        circ = TF.CompiledCircuit(n, TC.qft_prims(n), stage_group=group)
        got = TA.complex_from_state(circ(TA.state_from_planes(re, im)))
        assert rel(got, want) <= TOL


def test_stage_prepass_shapes():
    n = 12
    h = np.array([[1, 1], [1, -1]]) / math.sqrt(2)
    cu1 = np.array([1, 1, 1, 1j])
    shifted = np.array([1, 1, 1j, -1])  # d[2] != 1 still a ladder factor
    prims = [TPrim(h, (1,)), TPrim(cu1, (4, 1), True), TPrim(shifted, (1, 9), True),
             TPrim(h, (2,)), TPrim(cu1, (2, 3), True),
             TPrim(h, (3,)), TPrim(np.array([1j, 1, 1, 1]), (3, 6), True),  # not a ladder
             TPrim(h, (9,)), TPrim(cu1, (9, 10), True)]                      # lane head
    ops = TF.fuse(prims, n)
    assert isinstance(ops[0], TF.StageBlockOp)
    assert ops[0].targets == (1, 2)
    assert ops[0].stages[0][2][0][1] == (1, 4)  # stored (4, 1): permuted to (q, j)
    assert not any(isinstance(o, TF.StageBlockOp) and 3 in o.targets for o in ops)
    assert TF.plan(ops[0], n)[0] == "stage"
    with pytest.raises(ValueError, match="stage_group"):
        TF.fuse(prims, n, stage_group=5)


def test_wide_diagonal_fuses_without_densifying(monkeypatch):
    """A diagonal prim on more than 4 targets (a Grover oracle) becomes a
    DiagLayer factor directly: it is never turned into a dense matrix."""
    n = 12
    prims = TC.grover_prims(n, marked=1234, iterations=2)
    real = TF._prim_sorted_dense

    def guarded(p):
        assert len(p.targets) <= 4, f"densified a prim on {len(p.targets)} targets"
        return real(p)

    monkeypatch.setattr(TF, "_prim_sorted_dense", guarded)
    ops = TF.fuse(prims, n)
    assert all(len(op.targets) <= 4 for op in ops if isinstance(op, TF.DenseOp)
               and any(t < n - 7 for t in op.targets))
    wide = [f for op in ops if isinstance(op, TF.DiagLayer) for f in op.factors
            if len(f[1]) == n]
    assert len(wide) == 4 and all(f[1] == tuple(range(n)) for f in wide)
    _, got, want = run_both(n, JC.grover_prims(n, marked=1234, iterations=2))
    assert rel(got, want) <= TOL
    assert abs(got[1234]) ** 2 > 20 / (1 << n)  # the marked state grows


def test_wide_diagonal_target_order():
    """An unsorted wide diagonal is transposed into sorted target order."""
    n = 7
    rng = np.random.default_rng(4)
    d = np.exp(1j * rng.uniform(0, 2 * math.pi, 32))
    targets = (6, 0, 3, 2, 5)
    jprims = [JPrim(np.array([[0, 1], [1, 0]]), (1,)), JPrim(d, targets, diag=True)]
    ops = TF.fuse(to_port(jprims), n)
    assert [o.factors[0][1] for o in ops if isinstance(o, TF.DiagLayer)] == [(0, 2, 3, 5, 6)]
    _, got, want = run_both(n, jprims, seed=8)
    assert rel(got, want) <= TOL


def test_apply_prims_fused_runs_stage_blocks():
    n = 10
    v = rand_vec(n, 12).astype(np.complex64)
    a = torch.from_numpy(v.copy())
    TF.apply_prims_fused(a, TC.qft_prims(n), n)
    circ = TF.CompiledCircuit(n, TC.qft_prims(n))
    b = circ(torch.from_numpy(v.copy()))
    assert rel(a.numpy(), b.numpy()) <= TOL


def test_compiled_circuit_checks_the_state_device():
    circ = TF.CompiledCircuit(3, TC.ghz_prims(3))
    with pytest.raises(ValueError, match="planned on"):
        circ(torch.zeros(8, dtype=torch.complex64, device="meta"))
    h5 = TPrim(np.kron(np.eye(16), np.array([[0, 1], [1, 0]])), (0, 1, 2, 3, 4))
    with pytest.raises(ValueError, match="no kernel"):
        TF.CompiledCircuit(14, [h5])
