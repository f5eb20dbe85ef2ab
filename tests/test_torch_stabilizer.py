"""The port's stabilizer tableau engine against the JAX package's: the same
prims, random bits and shot bits go to both. Tableaux after a chain,
after a measurement and after a reset are equal word for word (with n =
31, 32, 33, 64 and 65 crossing word boundaries); so are expectations,
deterministic outcomes, ``affine_support``'s ``(x0, V)``, the affine
samples for the same bits, ``stabilizer_strings`` and the ``:dump`` text.
Outcomes drawn from each package's own generator are held by distribution
(``utils.stats.chi2_test`` at alpha 1e-3) or by the program's own law.
Every case of tests/test_stabilizer.py has its counterpart here or in
tests/test_torch_frames.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qubism_torch.config import config  # noqa: E402
from qubism_torch.core.gates import Prim as TPrim  # noqa: E402
from qubism_torch.qasm.parser import parse_openqasm as tparse  # noqa: E402
from qubism_torch.stabilizer import tableau as T  # noqa: E402
from qubism_torch.stabilizer import (NotCliffordError, StabilizerProgram,  # noqa: E402
                                     StabilizerSim, clifford_tables)
from qubism_torch.utils.profiling import count_ops  # noqa: E402
from qubism_torch.utils.stats import chi2_test  # noqa: E402
from qubism_tpu.core.gates import Prim as JPrim  # noqa: E402
from qubism_tpu.core.statevec import StateVec  # noqa: E402
from qubism_tpu.ops import apply as japply  # noqa: E402
from qubism_tpu.qasm.parser import parse_openqasm as jparse  # noqa: E402
from qubism_tpu.stabilizer import StabilizerProgram as JProgram  # noqa: E402
from qubism_tpu.stabilizer import StabilizerSim as JSim  # noqa: E402
from qubism_tpu.stabilizer import tableau as J  # noqa: E402

_H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2)
_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
_Z = np.diag([1.0, -1.0]).astype(np.complex128)
_S = np.diag([1.0, 1j]).astype(np.complex128)
_SDG = np.diag([1.0, -1j]).astype(np.complex128)
_CX = np.eye(4, dtype=np.complex128)[[0, 1, 3, 2]]
_CZ = np.diag([1.0, 1.0, 1.0, -1.0]).astype(np.complex128)
_SWAP = np.eye(4, dtype=np.complex128)[[0, 2, 1, 3]]
_ONE_Q = [_H, _X, _Y, _Z, _S, _SDG]
_TWO_Q = [_CX, _CZ, _SWAP]


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def random_prims(n, depth, rng):
    """(matrix, targets) pairs of a random Clifford circuit."""
    out = []
    for _ in range(depth):
        if n >= 2 and rng.random() < 0.4:
            a, b = rng.choice(n, size=2, replace=False)
            out.append((_TWO_Q[rng.integers(len(_TWO_Q))], (int(a), int(b))))
        else:
            out.append((_ONE_Q[rng.integers(len(_ONE_Q))], (int(rng.integers(n)),)))
    return out


def both(spec):
    return [TPrim(u, t) for u, t in spec], [JPrim(u, t) for u, t in spec]


def chains(n, spec):
    """The same chain through both packages: (port tableau, JAX tableau)."""
    tp, jp = both(spec)
    return T.apply_prims(T.identity_tableau(n), tp), J.apply_prims(J.identity_tableau(n), jp)


def assert_planes(tab, jtab):
    for a, b in zip(T.planes_from_tableau(tab), jtab):
        np.testing.assert_array_equal(a, np.asarray(b))


def dense_state(n, spec):
    sv = StateVec.zero(n)
    planes = sv.planes
    for u, t in spec:
        planes = japply.apply_gate(planes, u, t, n)
    return StateVec(n, planes)


def random_pauli(n, rng):
    return "".join(rng.choice(list("IXYZ")) for _ in range(n))


def ghz_spec(n):
    return [(_H, (0,))] + [(_CX, (q, q + 1)) for q in range(n - 1)]


def bits(k, seed):
    return np.random.default_rng(seed).integers(0, 2, k)


# -- planes, popcount, word boundaries ----------------------------------------


def test_popcount_matches_numpy():
    rng = np.random.default_rng(0)
    w = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    got = T._popcount(torch.from_numpy(w.view(np.int32).copy())).numpy()
    np.testing.assert_array_equal(got, np.bitwise_count(w))


@pytest.mark.parametrize("n", [31, 32, 33, 64, 65])
def test_chain_planes_equal_across_word_boundaries(n):
    rng = np.random.default_rng(n)
    spec = random_prims(n, 160, rng) + [(_CX, (0, n - 1)), (_SWAP, (n - 1, 31 % n))]
    tab, jtab = chains(n, spec)
    assert_planes(tab, jtab)
    back = T.tableau_from_planes(*T.planes_from_tableau(tab))
    assert all(torch.equal(a, b) for a, b in zip(back, tab))
    for _ in range(12):
        p = random_pauli(n, rng)
        assert T.expectation(tab, p, n) == J.expectation(jtab, p, n), p
    assert T.stabilizer_strings(tab, n) == J.stabilizer_strings(jtab, n)
    assert T.stabilizer_strings(tab, n, True) == J.stabilizer_strings(jtab, n, True)
    x0, v = T.affine_support(tab, n)
    jx0, jv = J.affine_support(jtab, n)
    np.testing.assert_array_equal(x0, jx0)
    np.testing.assert_array_equal(v, jv)


@pytest.mark.parametrize("n", [31, 33, 65])
def test_measure_seq_equals_jax_with_injected_bits(n):
    rng = np.random.default_rng(100 + n)
    tab, jtab = chains(n, random_prims(n, 150, rng))
    qs = [int(q) for q in rng.permutation(n)[:24]] + [0, n - 1]
    rb = bits(len(qs), n)
    outs, tab2 = T.measure_seq(tab, qs, torch.tensor(rb), n)
    jouts, jx, jz, js = J._measure_seq_impl(
        jtab.x, jtab.z, jtab.s, jnp.asarray(np.asarray(qs, np.uint32)),
        jnp.asarray(rb.astype(bool)), n)
    assert outs.tolist() == [int(b) for b in np.asarray(jouts)]
    assert_planes(tab2, (jx, jz, js))


def test_measure_seq_per_qubit_route_past_the_guard(monkeypatch):
    """Past _DET_BATCH_MAX_N every qubit is a round (the integer prefix
    fold): the same outcomes and tableau as the JAX scan."""
    monkeypatch.setattr(T, "_DET_BATCH_MAX_N", 4)
    n = 33
    rng = np.random.default_rng(7)
    tab, jtab = chains(n, random_prims(n, 120, rng))
    qs = list(range(n))
    rb = bits(n, 8)
    T.reset_stats()
    outs, tab2 = T.measure_seq(tab, qs, torch.tensor(rb), n)
    assert T.stats["rounds"] == n
    jouts, jx, jz, js = J._measure_seq_impl(
        jtab.x, jtab.z, jtab.s, jnp.asarray(np.arange(n, dtype=np.uint32)),
        jnp.asarray(rb.astype(bool)), n)
    assert outs.tolist() == [int(b) for b in np.asarray(jouts)]
    assert_planes(tab2, (jx, jz, js))


def test_batched_measure_equals_jax_per_tableau():
    """A (T, 2n, W) batch of different tableaux with different bits: each
    row gives the JAX scan's outcomes and tableau (the torch.where of the
    random and deterministic branches, a round per first random qubit)."""
    n, batch = 9, 5
    rng = np.random.default_rng(3)
    specs = [random_prims(n, 40, rng) for _ in range(batch)]
    tabs = [chains(n, s) for s in specs]
    stack = T.Tableau(*(torch.stack([t[0][i] for t in tabs]) for i in range(3)))
    qs = [4, 0, 8, 4, 2]
    rb = np.random.default_rng(4).integers(0, 2, (batch, len(qs)))
    outs, new = T.measure_seq(stack, qs, torch.tensor(rb), n)
    for b, (_, jtab) in enumerate(tabs):
        jouts, jx, jz, js = J._measure_seq_impl(
            jtab.x, jtab.z, jtab.s, jnp.asarray(np.asarray(qs, np.uint32)),
            jnp.asarray(rb[b].astype(bool)), n)
        assert outs[b].tolist() == [int(v) for v in np.asarray(jouts)]
        assert_planes(T.Tableau(new.x[b], new.z[b], new.s[b]), (jx, jz, js))


@pytest.mark.parametrize("n", [33, 65])
def test_layer_steps_equal_jax(n):
    """Runs of prims on disjoint qubits are one step each (a CX fan across
    the word boundaries, a SWAP / CZ layer, a 1q layer): the planes of the
    JAX package's prim-by-prim scan, also on a batch of tableaux, in a fixed
    handful of ops per layer."""
    fan = [(_CX, (i, n - 1 - i)) for i in range(n // 2)]
    mixed = [(_SWAP if i % 2 else _CZ, (2 * i, 2 * i + 1)) for i in range(n // 2)]
    ones = [(_ONE_Q[q % 6], (q,)) for q in range(n)]
    spec = ones + [(_H, (0,))] + fan + mixed + ones[::-1] + fan
    tp, jp = both(spec)
    steps = T._steps(tp, [T._gate_table(p.dense(), torch.device("cpu")) for p in tp])
    assert [k for k, *_ in steps][:4] == ["layer", "one", "layer", "layer"]
    tab, jtab = chains(n, spec)
    assert_planes(tab, jtab)
    batch = T.identity_tableau(n, batch=3)
    out = T.apply_prims(batch, tp)
    for b in range(3):
        assert_planes(T.Tableau(out.x[b], out.z[b], out.s[b]), jtab)
    ops = count_ops(lambda: T.apply_prims(tab, tp[n + 1:n + 1 + len(fan)]))[1]
    assert ops <= 45


def test_gate_step_op_count():
    """A 2-qubit gate step dispatches a fixed handful of torch ops (each
    about one launch on the card), whatever n is."""
    counts = []
    for n in (8, 200):
        tab = T.identity_tableau(n)
        counts.append(count_ops(lambda: T.apply_prims(tab, [TPrim(_CX, (1, n - 1))]))[1])
    assert counts[0] == counts[1] <= 40


# -- the cases of tests/test_stabilizer.py ---------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_clifford_expectations_match(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 6))
    spec = random_prims(n, 40, rng)
    sv = dense_state(n, spec)
    tp, jp = both(spec)
    sim, jsim = StabilizerSim(n).apply(tp), JSim(n).apply(jp)
    assert_planes(sim.tab, jsim.tab)
    for _ in range(25):
        p = random_pauli(n, rng)
        got = sim.expectation(p)
        assert got == jsim.expectation(p)
        assert got == pytest.approx(sv.expectation(p), abs=1e-5), p


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_measurement_probability_and_collapse_match(seed):
    """Each qubit measured with the same injected bit in both packages: the
    same outcome and post-measurement tableau; the dense engine's
    probability says whether it was random."""
    rng = np.random.default_rng(seed)
    n = 4
    spec = random_prims(n, 30, rng)
    sv = dense_state(n, spec)
    tab, jtab = chains(n, spec)
    for q in range(n):
        rb = int(rng.integers(2))
        out, tab2 = T.measure_seq(tab, [q], torch.tensor([rb]), n)
        jout, jx, jz, js = J._measure_impl(jtab.x, jtab.z, jtab.s, jnp.uint32(q),
                                           jnp.asarray(bool(rb)), n)
        assert int(out[0]) == int(jout)
        assert_planes(tab2, (jx, jz, js))
        p1 = sv.prob_one(q)
        if 1e-6 < p1 < 1 - 1e-6:
            assert p1 == pytest.approx(0.5, abs=1e-5) and int(out[0]) == rb
        else:
            assert int(out[0]) == round(p1)
        post = sv.collapse(q, int(out[0]))
        for _ in range(6):
            pauli = random_pauli(n, rng)
            assert T.expectation(tab2, pauli, n) == pytest.approx(post.expectation(pauli), abs=1e-5)


def test_sequential_register_measurement_distribution():
    tp, jp = both(ghz_spec(3))
    sim = StabilizerSim(3, seed=0).apply(tp)
    b = sim.sample(400)
    assert b.shape == (400, 3) and (b == b[:, :1]).all()
    assert chi2_test(np.bincount(b[:, 0], minlength=2), [0.5, 0.5])
    x0, v = sim._support
    jx0, jv = J.affine_support(JSim(3).apply(jp).tab, 3)
    np.testing.assert_array_equal(x0, jx0)
    np.testing.assert_array_equal(v, jv)


def test_plus_state_sampling_is_uniform():
    n = 3
    sim = StabilizerSim(n, seed=1).apply([TPrim(_H, (q,)) for q in range(n)])
    b = sim.sample(800)
    idx = (b * (1 << np.arange(n - 1, -1, -1))).sum(axis=1)
    assert chi2_test(np.bincount(idx, minlength=8), np.full(8, 1 / 8))


@pytest.mark.parametrize("seed", [12, 13, 14])
def test_affine_sampler_matches_jax_bit_for_bit(seed):
    """The same shot bits (jax.random.bernoulli on the JAX sampler's key)
    through both samplers give the same rows; the rows follow the dense
    engine's Born distribution."""
    rng = np.random.default_rng(seed)
    n, shots = 4, 2000
    spec = random_prims(n, 35, rng)
    tab, jtab = chains(n, spec)
    x0, v = T.affine_support(tab, n)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(J._affine_sample_impl(jnp.asarray(x0), jnp.asarray(v), key, shots))
    r = np.asarray(jax.random.bernoulli(key, 0.5, (shots, v.shape[0])), dtype=np.int32)
    got = T.affine_sample(torch.from_numpy(x0), torch.from_numpy(v), torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(got, want)
    probs = np.abs(dense_state(n, spec).amps) ** 2
    idx = (got.astype(np.int64) * (1 << np.arange(n - 1, -1, -1))).sum(axis=1)
    assert chi2_test(np.bincount(idx, minlength=1 << n), probs / probs.sum())


def test_affine_sampler_after_collapse_respects_outcome():
    tp, _ = both(ghz_spec(4))
    sim = StabilizerSim(4, seed=7).apply(tp)
    out = sim.measure_qubit(0)
    assert (sim.sample(200) == out).all()


def test_sample_8192_shots_at_1000_qubits():
    n = 1000
    tp, jp = both(ghz_spec(n))
    sim = StabilizerSim(n, seed=0).apply(tp)
    assert_planes(sim.tab, J.apply_prims(J.identity_tableau(n), jp))
    b = sim.sample(8192)
    assert b.shape == (8192, n) and (b == b[:, :1]).all()
    assert abs(b[:, 0].mean() - 0.5) < 4 * 0.5 / np.sqrt(8192)


def test_measure_qubits_matches_semantics():
    tp, jp = both(ghz_spec(5))
    sim = StabilizerSim(5, seed=9).apply(tp)
    T.reset_stats()
    outs = sim.measure_qubits(range(5))
    assert T.stats["rounds"] == 2
    assert len(set(outs)) == 1 and sim.measure_qubit(3) == outs[0]


def test_measure_qubit_idempotent():
    rng = np.random.default_rng(11)
    tp, _ = both(random_prims(4, 25, rng))
    sim = StabilizerSim(4, seed=3).apply(tp)
    first = sim.measure_qubit(2)
    assert all(sim.measure_qubit(2) == first for _ in range(5))


def test_reset_projects_to_zero():
    tp, jp = both([(_H, (0,)), (_CX, (0, 1))])
    sim, jsim = StabilizerSim(2, seed=0).apply(tp), JSim(2, seed=0).apply(jp)
    sim.reset(0)
    jsim.reset(0)
    assert_planes(sim.tab, jsim.tab)
    assert sim.expectation("ZI") == 1.0 and sim.measure_qubit(0) == 0
    # a |1>-certain qubit takes the X flip
    one, jone = StabilizerSim(1).apply([TPrim(_X, (0,))]), JSim(1).apply([JPrim(_X, (0,))])
    one.reset(0)
    jone.reset(0)
    assert_planes(one.tab, jone.tab)
    assert one.measure_qubit(0) == 0


def test_non_clifford_rejected_with_clear_error():
    t = np.diag([1.0, np.exp(1j * np.pi / 4)]).astype(np.complex128)
    with pytest.raises(NotCliffordError, match="stabilizer backend supports"):
        StabilizerSim(1).apply([TPrim(t, (0,))])
    with pytest.raises(NotCliffordError):
        clifford_tables(np.array([[1, 1], [0, 1]], dtype=np.complex128))
    for u in (_H, _S, _CX, _SWAP):
        for a, b in zip(clifford_tables(u), J.clifford_tables(u)):
            np.testing.assert_array_equal(a, b)


def test_diag_prims_supported():
    cz = np.array([1, 1, 1, -1], dtype=np.complex128)
    sim = StabilizerSim(2).apply([TPrim(_H, (0,)), TPrim(_H, (1,)), TPrim(cz, (0, 1), diag=True)])
    jsim = JSim(2).apply([JPrim(_H, (0,)), JPrim(_H, (1,)), JPrim(cz, (0, 1), diag=True)])
    assert_planes(sim.tab, jsim.tab)
    assert sim.expectation("XZ") == 1.0 and sim.expectation("ZX") == 1.0


def test_ghz_1000_qubits_scales():
    """GHZ-1000: the JAX expectations, and the whole register read in 2
    rounds (the random qubit 0, then 999 deterministic ones at once)."""
    n = 1000
    tp, jp = both(ghz_spec(n))
    sim = StabilizerSim(n, seed=0).apply(tp)
    jtab = J.apply_prims(J.identity_tableau(n), jp)
    for p in ("Z" * n, "X" * n, "Z" + "I" * (n - 1), "Z" + "I" * (n - 2) + "Z"):
        assert sim.expectation(p) == J.expectation(jtab, p, n), p
    assert sim.expectation("X" * n) == 1.0
    T.reset_stats()
    outs = sim.measure_qubits(range(n))
    assert T.stats["rounds"] == 2 and T.stats["syncs"] == 3
    assert len(set(outs)) == 1


def test_stabilizer_strings_readable():
    sim = StabilizerSim(2).apply([TPrim(_H, (0,)), TPrim(_CX, (0, 1))])
    assert sim.stabilizers() == ["+XX", "+ZZ"]
    sim.apply([TPrim(_Z, (0,))])
    assert sim.stabilizers() == ["-XX", "+ZZ"]


def test_det_outcomes_batch_matches_sequential_measure():
    rng = np.random.default_rng(11)
    checked = 0
    for _ in range(12):
        n = int(rng.integers(3, 12))
        spec = random_prims(n, 40, rng)
        tab, jtab = chains(n, spec)
        xn = np.asarray(jtab.x)[n:]
        det = [q for q in range(n) if not ((xn[:, q >> 5] >> (q & 31)) & 1).any()]
        if not det:
            continue
        anyr, outs = T.det_outcomes(tab, det, n)
        janyr, jouts = J._det_outcomes_impl(jtab.x, jtab.z, jtab.s,
                                            jnp.asarray(np.asarray(det, np.uint32)), n)
        assert not bool(anyr) and not bool(janyr)
        assert outs.tolist() == [int(b) for b in np.asarray(jouts)]
        for q, got in zip(det, outs.tolist()):
            ref = J._measure_impl(jtab.x, jtab.z, jtab.s, jnp.uint32(q), jnp.asarray(False), n)[0]
            assert got == int(ref)
            checked += 1
    assert checked > 20


def test_det_outcomes_batch_flags_random_qubits():
    tab = T.apply_prims(T.identity_tableau(2), [TPrim(_H, (0,))])
    assert bool(T.det_outcomes(tab, [0], 2)[0])
    assert not bool(T.det_outcomes(tab, [1], 2)[0])


def test_seeded_runs_reproducible():
    rng = np.random.default_rng(21)
    tp, _ = both(random_prims(5, 30, rng))

    def run():
        sim = StabilizerSim(5, seed=42).apply(tp)
        return [sim.measure_qubit(q) for q in range(5)]

    assert run() == run()


# -- QASM programs ----------------------------------------------------------------


def run_both(src, seed=0, dump=False):
    tchunks, jchunks = [], []
    t = StabilizerProgram(tparse("<test>", src)).run(seed=seed, dump_writer=tchunks.append)
    j = JProgram(jparse("<test>", src)).run(seed=seed, dump_writer=jchunks.append)
    return t, j, "".join(tchunks), "".join(jchunks)


def test_qasm_bell_with_feedforward():
    src = """
    qreg q[2]; creg c[2];
    U(pi/2, 0, pi) q[0];
    CX q[0], q[1];
    measure q[0] -> c[0];
    if (c == 1) CX q[0], q[1];
    if (c == 1) U(pi, 0, pi) q[0];
    measure q -> c;
    """
    for seed in range(6):
        (_, cregs), (_, jcregs), _, _ = run_both(src, seed)
        assert cregs["c"].to_natural() == jcregs["c"].to_natural() == 0


def test_qasm_teleportation_of_plus_state():
    src = """
    qreg q[3]; creg c0[1]; creg c1[1];
    U(pi/2, 0, pi) q[0];
    U(pi/2, 0, pi) q[1]; CX q[1], q[2];
    CX q[0], q[1]; U(pi/2, 0, pi) q[0];
    measure q[0] -> c0[0];
    measure q[1] -> c1[0];
    if (c0 == 1) U(0, 0, pi) q[2];
    if (c1 == 1) U(pi, 0, pi) q[2];
    """
    for seed in range(4):
        (sim, _), (jsim, _), _, _ = run_both(src, seed)
        assert sim.expectation("IIX") == jsim.expectation("IIX") == 1.0


def test_qasm_non_clifford_raises():
    with pytest.raises(NotCliffordError):
        StabilizerProgram(tparse("<test>", "qreg q[1]; U(pi/4, 0, 0) q[0];")).run()


def test_qasm_dump_text_equals_jax():
    src = ("qreg q[2]; qreg a[1]; creg c[2]; U(pi/2,0,pi) q[0]; CX q[0],q[1]; "
           "U(pi,0,pi) a[0]; measure a[0] -> c[1]; :dump;")
    _, _, text, jtext = run_both(src)
    assert "  +XXI\n  +ZZI\n  -IIZ\n" in text and "CReg c[2] = 01" in text
    assert text == jtext
