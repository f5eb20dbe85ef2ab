"""The port's MPS engine (qubism_torch/mps: MPSSim, MPSProgram, the tape
construction) against the JAX package's on the CPU: the same prims or QASM go
to both, and only gauge-invariant values are compared, since LAPACK's SVD
and the JAX package's Jacobi return other phases and other columns for
zero singular values: dense states, amplitudes, expectations, norms,
prob_one and entropies to 1e-5 where chi suffices, ``trunc_error`` to a
relative 1e-3 where it truncates (and exactly 0.0 where it does not),
the ``:dump`` text with its numbers within 1e-4, the tape rows exactly
(operands to 1e-12). Sampling is held bit for bit against a numpy
sequential sampler on ``to_statevec()`` with the same uniforms injected.
Every case of tests/test_mps.py but the four of the split-real Jacobi
SVD (which the port does not have: it calls ``torch.linalg.svd``) has its
counterpart here or in tests/test_torch_mps_noise.py."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qubism_tpu as jq  # noqa: E402
from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim as TPrim  # noqa: E402
from qubism_torch.mps import MPSProgram, MPSSim, NotAdjacentError  # noqa: E402
from qubism_torch.mps import engine as TE  # noqa: E402
from qubism_torch.qasm.parser import parse_openqasm as tparse  # noqa: E402
from qubism_tpu.core.gates import Prim as JPrim  # noqa: E402
from qubism_tpu.mps import MPSProgram as JProgram  # noqa: E402
from qubism_tpu.mps import MPSSim as JSim  # noqa: E402
from qubism_tpu.mps import engine as JE  # noqa: E402
from qubism_tpu.qasm.parser import parse_openqasm as jparse  # noqa: E402

_H = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
_X = np.array([[0, 1], [1, 0]], dtype=complex)
_CX = np.eye(4, dtype=complex)[[0, 1, 3, 2]]
#: gauge-invariant values where chi suffices (float32 states)
TOL = 1e-5


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def _haar(k, rng):
    m = rng.normal(size=(k, k)) + 1j * rng.normal(size=(k, k))
    q, r = np.linalg.qr(m)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _random_gates(n, depth, rng, two_q_prob=0.5):
    """(matrix, targets) pairs, given to both packages' Prim."""
    out = []
    for _ in range(depth):
        if n >= 2 and rng.random() < two_q_prob:
            a, b = rng.choice(n, size=2, replace=False)
            out.append((_haar(4, rng), (int(a), int(b))))
        else:
            out.append((_haar(2, rng), (int(rng.integers(n)),)))
    return out


def tprims(gates):
    return [TPrim(u, t) for u, t in gates]


def jprims(gates):
    return [JPrim(u, t) for u, t in gates]


def both(n, gates, **kw):
    return (MPSSim(n, seed=0, **kw).apply(tprims(gates)),
            JSim(n, seed=0, **kw).apply(jprims(gates)))


def _dense(n, gates):
    sv = jq.mk_state_vec(n)
    for p in jprims(gates):
        sv = jq.Gate(n, [p])(sv)
    return sv.amps


def ghz(n):
    return [(_H, (0,))] + [(_CX, (q, q + 1)) for q in range(n - 1)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_circuit_matches_dense(seed):
    rng = np.random.default_rng(seed)
    n = 5
    gates = _random_gates(n, 20, rng)
    t, j = both(n, gates, chi=1 << (n // 2 + 1))
    got = t.to_statevec()
    assert np.linalg.norm(got - j.to_statevec()) < TOL
    assert np.linalg.norm(got - _dense(n, gates)) < 2e-4      # the reference's bound
    assert t.trunc_error == 0.0 and j.trunc_error < 1e-9


def test_expectation_and_amplitude_match_dense():
    rng = np.random.default_rng(9)
    n = 4
    gates = _random_gates(n, 15, rng)
    t, j = both(n, gates, chi=8)
    for bits in ((0,) * n, (1,) * n, (0, 1, 0, 1), (1, 1, 0, 0)):
        assert abs(t.amplitude(bits) - j.amplitude(bits)) < TOL
    for pauli in ("ZZZZ", "XIXI", "IYYI", "ZXYZ", "IIII"):
        assert abs(t.expectation(pauli) - j.expectation(pauli)) < TOL
    assert abs(t.norm() - j.norm()) < TOL
    with pytest.raises(ValueError, match="bad Pauli string"):
        t.expectation("ZZ")
    with pytest.raises(ValueError, match="one bit per qubit"):
        t.amplitude((0, 1))


def sequential_sample(psi, n, u):
    """Bits of each shot drawn qubit by qubit from the exact conditionals
    of ``psi`` (float64), by the port's rule: bit = u (p0 + p1) >= p0."""
    p = np.abs(psi.reshape((2,) * n)) ** 2
    out = np.zeros(u.shape, dtype=np.uint8)
    for s in range(u.shape[0]):
        cond = p
        for q in range(n):
            marg = cond.reshape(2, -1).sum(1)
            bit = int(u[s, q] * marg.sum() >= marg[0])
            out[s, q] = bit
            cond = cond[bit]
    return out


def test_sampling_distribution_chi2():
    rng = np.random.default_rng(21)
    n = 4
    gates = _random_gates(n, 18, rng)
    t, j = both(n, gates, chi=8)
    probs = np.abs(j.to_statevec()) ** 2
    shots = 4000
    bits = t.sample(shots)
    assert bits.shape == (shots, n) and bits.dtype == np.uint8
    idx = (bits.astype(np.int64) * (1 << np.arange(n - 1, -1, -1))).sum(1)
    counts = np.bincount(idx, minlength=1 << n)
    live = probs > 1e-9
    expected = probs[live] * shots
    chi2 = (((counts[live] - expected) ** 2) / expected).sum()
    dof = live.sum() - 1
    assert chi2 < dof + 3.1 * np.sqrt(2 * dof) + 4, (chi2, dof)   # the reference's bound
    assert (counts[~live] == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_injected_uniforms_bit_for_bit(seed):
    """The same uniforms through the MPS walk and through a numpy
    sequential sampler on to_statevec() give the same bits, index for
    index (n = 6 and 8, 512 shots)."""
    rng = np.random.default_rng(100 + seed)
    n = 6 + 2 * seed
    t = MPSSim(n, chi=16).apply(tprims(_random_gates(n, 30, rng)))
    u = rng.random((512, n))
    got = t.sample(512, uniforms=u)
    assert np.array_equal(got, sequential_sample(t.to_statevec(), n, u))
    # a GHZ's sample: every row all equal, both values seen
    g = MPSSim(8, chi=4).apply(tprims(ghz(8)))
    b = g.sample(256)
    assert (b == b[:, :1]).all() and 0 < b[:, 0].mean() < 1


def test_mid_circuit_measurement_ghz():
    n = 8
    t = MPSSim(n, chi=4, seed=3).apply(tprims(ghz(n)))
    out = t.measure_qubit(0)
    # perfectly correlated: every remaining qubit yields the same outcome
    assert t.measure_qubits(range(1, n)) == [out] * (n - 1)
    assert abs(t.norm() - 1.0) < 1e-4
    # the collapsed state is the JAX package's for the same outcome
    j = JSim(n, chi=4).apply(jprims(ghz(n)))
    proj = np.diag([1.0 - out, float(out)]).astype(complex)
    j._apply_1q(proj, 0)
    psi = j.to_statevec()
    assert np.linalg.norm(t.to_statevec() - psi / np.linalg.norm(psi)) < TOL


def test_reset_projects_to_zero():
    gates = [(_H, (0,)), (_CX, (0, 1)), (_X, (2,))]
    t, j = both(3, gates, chi=4)
    t.reset(1)
    j.reset(1)
    assert t.prob_one(1) < 1e-6
    assert t.prob_one(2) > 1 - 1e-6
    for q in range(3):
        assert abs(t.prob_one(q) - j.prob_one(q)) < TOL
    assert np.linalg.norm(t.to_statevec() - j.to_statevec()) < TOL


def test_hundred_qubit_ghz():
    n = 100
    t, j = both(n, ghz(n), chi=4)
    assert t.trunc_error == 0.0 and j.trunc_error == 0.0
    assert abs(t.norm() - 1.0) < 1e-3
    assert abs(t.expectation("Z" * n) - 1.0) < 1e-3  # parity of GHZ
    assert abs(t.expectation("Z" * n) - j.expectation("Z" * n)) < TOL
    assert abs(t.entanglement_entropy(49) - np.log(2)) < 1e-3
    assert abs(t.entanglement_entropy(49) - j.entanglement_entropy(49)) < TOL
    assert abs(t.amplitude([1] * n) - j.amplitude([1] * n)) < TOL
    bits = t.sample(256)
    assert bits.shape == (256, n)
    assert (bits == bits[:, :1]).all()
    frac = bits[:, 0].mean()
    assert 0.35 < frac < 0.65


def test_truncation_degrades_gracefully():
    rng = np.random.default_rng(31)
    n = 6
    gates = _random_gates(n, 40, rng, two_q_prob=0.8)
    exact = MPSSim(n, chi=8, seed=0).apply(tprims(gates))
    assert exact.trunc_error == 0.0
    t, j = both(n, gates, chi=2)
    assert t.trunc_error > 1e-4          # it noticed
    assert abs(t.norm() - 1.0) < 1e-3    # but stayed normalized
    # the same Schmidt spectra are cut: the discarded weight to 1e-3
    assert abs(t.trunc_error - j.trunc_error) <= 1e-3 * j.trunc_error
    assert abs(abs(np.vdot(t.to_statevec(), j.to_statevec())) - 1.0) < 1e-4


def test_entropy_matches_statevec():
    rng = np.random.default_rng(41)
    n = 6
    gates = _random_gates(n, 25, rng)
    t, j = both(n, gates, chi=8)
    sv = jq.StateVec.from_amplitudes(_dense(n, gates))
    for bond in (1, 2, 4, 0, 3):
        got = t.entanglement_entropy(bond)
        assert abs(got - j.entanglement_entropy(bond)) < TOL, bond
        assert abs(got - sv.entanglement_entropy(tuple(range(bond + 1)))) < 1e-3, bond
    with pytest.raises(ValueError, match="bond out of range"):
        t.entanglement_entropy(n - 1)


def test_wide_prim_rejected():
    ccx = np.eye(8, dtype=complex)
    ccx[6:, 6:] = np.array([[0, 1], [1, 0]])
    with pytest.raises(NotAdjacentError) as te:
        MPSSim(3, chi=4).apply([TPrim(ccx, (0, 1, 2))])
    with pytest.raises(JE.NotAdjacentError) as je:
        JSim(3, chi=4).apply([JPrim(ccx, (0, 1, 2))])
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="n >= 1"):
        MPSSim(0)


TELEPORT = """OPENQASM 2.0;
include "examples/qelib1.inc";
qreg q[3];
creg c0[1];
creg c1[1];
creg c2[1];
x q[0];
h q[1];
cx q[1],q[2];
cx q[0],q[1];
h q[0];
measure q[0] -> c0[0];
measure q[1] -> c1[0];
if (c1 == 1) x q[2];
if (c0 == 1) z q[2];
measure q[2] -> c2[0];
"""


def test_qasm_program_teleportation():
    """Mid-circuit measurement and feed-forward: the teleported state is
    |1> on every seed, and both measured bits are seen."""
    seen = set()
    for seed in range(6):
        prog = MPSProgram(tparse("<test>", TELEPORT), chi=4)
        sim, cregs = prog.run(seed=seed)
        assert cregs["c2"].to_natural() == 1, seed
        assert sim.prob_one(2) > 1 - 1e-6
        seen.add((cregs["c0"].to_natural(), cregs["c1"].to_natural()))
    assert len(seen) > 1


def numbers(text):
    """The text with its decimal numbers cut out, and the numbers."""
    pat = r"-?\d+\.\d+(?:e[-+]\d+)?"
    return re.sub(pat, "#", text), [float(x) for x in re.findall(pat, text)]


def test_qasm_dump_writer():
    """The dump text is the JAX package's word for word, its numbers (norm,
    trunc_error, bond entropies) within 1e-4; a deterministic program,
    and the 10-qubit brickwork whose 9 bonds print 8 entropies and ' ...'."""
    from qubism_torch.models.circuits import brickwork_qasm

    bell = "OPENQASM 2.0;\ninclude \"examples/qelib1.inc\";\nqreg q[2];\nqreg r[1];\n" \
           "creg c[2];\nh q[0];\ncx q[0],q[1];\nx r[0];\n"
    for src, chi in ((bell, 4), (brickwork_qasm(10, 3, seed=2, measure=False)
                                 .replace('"qelib1.inc"', '"examples/qelib1.inc"'), 8)):
        tp, jp = MPSProgram(tparse("<t>", src), chi=chi), JProgram(jparse("<t>", src), chi=chi)
        (ts, tc), (js, jc) = tp.run(seed=0), jp.run(seed=0)
        ttext, tnum = numbers(tp._pretty(ts, tc))
        jtext, jnum = numbers(jp._pretty(js, jc))
        assert ttext == jtext
        assert np.allclose(tnum, jnum, atol=1e-4, rtol=0)
        assert "mps backend" in ttext and f"chi={chi}" in ttext and "trunc_error" in ttext
    # a program with no qubits
    tp, jp = MPSProgram(tparse("<t>", "creg c[2];")), JProgram(jparse("<t>", "creg c[2];"))
    assert tp.run()[0] is None
    assert tp._pretty(None, tp.run()[1]) == jp._pretty(None, jp.run()[1])


def test_expectation_sum_matches_dense():
    rng = np.random.default_rng(51)
    n = 4
    gates = _random_gates(n, 15, rng)
    t, j = both(n, gates, chi=8)
    terms = [(0.5, "ZZII"), (-0.25, "XIXI"), (1.5, "IYYI"), (0.3, "ZXYZ"), (2.0, "IIII")]
    assert abs(t.expectation_sum(terms) - j.expectation_sum(terms)) < TOL
    sv = jq.StateVec.from_amplitudes(_dense(n, gates))
    want = sum(c * sv.expectation(p) for c, p in terms)
    assert abs(t.expectation_sum(terms) - want) < 1e-3


# -- the tape ----------------------------------------------------------------


@pytest.mark.parametrize("seed,center", [(0, 0), (1, 3), (2, 5)])
def test_build_tape_rows_match_jax(seed, center):
    """The same (code, site) rows, final center and on_gate calls (SWAP
    routing of non-adjacent and descending gates, the center rule), the
    same operands to 1e-12; pack_tape's arrays equal the JAX planes."""
    rng = np.random.default_rng(seed)
    gates = _random_gates(6, 25, rng, two_q_prob=0.6)
    calls = {"t": [], "j": []}
    tt, tc = TE.build_tape(tprims(gates), center,
                           on_gate=lambda tape, s, lg: calls["t"].append((len(tape), s, lg)))
    jt, jc = JE.build_tape(jprims(gates), center,
                           on_gate=lambda tape, s, lg: calls["j"].append((len(tape), s, lg)))
    assert tc == jc and calls["t"] == calls["j"]
    assert [(c, q) for c, q, _ in tt] == [(c, q) for c, q, _ in jt]
    for (_, _, a), (_, _, b) in zip(tt, jt):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.abs(a - b).max() < 1e-12
    codes, qs, us = TE.pack_tape(tt)
    jcodes, jqs, urs, uis = JE.pack_tape(jt, len(jt))
    assert np.array_equal(codes, jcodes) and np.array_equal(qs, jqs)
    assert np.array_equal(us.real, urs) and np.array_equal(us.imag, uis)
    assert TE.pack_tape(tt, len(tt) + 3)[0][-1] == TE._OP_NOP


# -- adaptive bond dimension ---------------------------------------------------


def test_adaptive_chi_grows_under_budget():
    """A depth-8 brickwork at n=10 needs chi=16: fixed chi=8 blows the
    budget, adaptive chi (from 4) grows on rollback to the JAX package's
    final chi and matches its state to 1e-5 (and the dense oracle)."""
    from qubism_torch.models.circuits import brickwork_prims
    from qubism_tpu.models.circuits import brickwork_prims as jbrickwork
    from qubism_tpu.ops.apply import complex_from_planes, zero_state
    from qubism_tpu.ops.fusion import CompiledCircuit

    n, depth = 10, 8
    tp, jp = brickwork_prims(n, depth=depth, seed=11), jbrickwork(n, depth=depth, seed=11)
    m8 = MPSSim(n, chi=8, seed=0).apply(tp)
    j8 = JSim(n, chi=8, seed=0).apply(jp)
    assert m8.trunc_error > 1e-6          # fixed chi=8 fails the budget
    assert abs(m8.trunc_error - j8.trunc_error) <= 1e-3 * j8.trunc_error
    ma = MPSSim(n, chi=4, seed=0, trunc_budget=1e-6, max_chi=64).apply(tp)
    ja = JSim(n, chi=4, seed=0, trunc_budget=1e-6, max_chi=64).apply(jp)
    assert ma.chi == ja.chi > 4 and ma.trunc_error <= 1e-6
    assert ma.trunc_error == 0.0
    # the JAX package's float32 Jacobi drifts its norm by ~1e-5 over this
    # depth: the states are held by fidelity to it, and to the dense JAX
    # oracle (the reference holds 1e-3 there) at 1e-5 up to the phase
    got, want = ma.to_statevec(), ja.to_statevec()
    fid = abs(np.vdot(got, want)) / (np.linalg.norm(got) * np.linalg.norm(want))
    assert abs(fid - 1.0) < TOL
    psi = complex_from_planes(CompiledCircuit(n, jp, optimize=False)(zero_state(n))).reshape(-1)
    k = int(np.argmax(np.abs(psi)))
    got = got * (psi[k] / got[k]) * (abs(got[k]) / abs(psi[k]))
    assert np.linalg.norm(got - psi) < TOL


def test_adaptive_chi_budget_violation_raises():
    from qubism_torch.models.circuits import brickwork_prims

    m = MPSSim(10, chi=4, seed=0, trunc_budget=1e-9, max_chi=8)
    before = m.sites
    with pytest.raises(FloatingPointError, match="trunc_budget 1e-09 exceeded at max_chi=8"):
        m.apply(brickwork_prims(10, depth=8, seed=11))
    # the failed call left the state it started from (grown to max_chi)
    assert m.chi == 8 and m.center == 0 and m.trunc_error == 0.0
    assert torch.equal(m.sites[:, :4, :, :4], before)


def test_adaptive_chi_product_state_stays_small():
    """Product-state circuits never escalate: start at chi=2, pay nothing."""
    m = MPSSim(12, chi=2, seed=0, trunc_budget=0.0)
    m.apply([TPrim(_H, (q,)) for q in range(12)])
    assert m.chi == 2 and m.trunc_error == 0.0
    assert abs(m.expectation("X" * 12) - 1.0) < 1e-5


def test_apply_leaves_a_held_state_untouched():
    """Every call works on a clone: a reference taken before an apply,
    a measurement or a reset still holds the state it held."""
    m = MPSSim(4, chi=4, seed=1).apply(tprims(ghz(4)))
    held = m.sites
    copy = held.clone()
    m.apply([TPrim(_X, (2,)), TPrim(_CX, (1, 3))])
    m.measure_qubit(0)
    m.reset(1)
    m.entanglement_entropy(2)
    assert torch.equal(held, copy)


def test_apply_takes_gates_and_prim_streams():
    """A DSL Gate (nested in a list with prims) flattens to its prims: the
    JAX package's state for the same stream."""
    import qubism_torch as tq

    g = tq.cnot(0, 2, 3) @ tq.on_just(0, tq.hadamard(), 3)
    t = MPSSim(3, chi=4).apply([g, TPrim(_X, (1,))])
    j = JSim(3, chi=4).apply(jq.cnot(0, 2, 3) @ jq.on_just(0, jq.hadamard(), 3)).apply(
        [JPrim(_X, (1,))])
    assert np.linalg.norm(t.to_statevec() - j.to_statevec()) < TOL
    assert t.apply([]) is t and t.center == j.center


def test_reset_of_a_one_certain_qubit_flips():
    """Projection to |0> of a |1>-certain qubit is the zero vector: both
    packages fall back to the X flip and keep the entangled partner."""
    gates = [(_X, (0,)), (_H, (1,)), (_CX, (1, 2))]
    t, j = both(3, gates, chi=4)
    t.reset(0)
    j.reset(0)
    assert t.prob_one(0) < 1e-6
    assert np.linalg.norm(t.to_statevec() - j.to_statevec()) < TOL
